"""Multi-process serving runtime on torch.distributed (counterpart of
spiral_tpu/dist/multihost.py).

One process drives one device (the JAX package runs one process per host
over all of its chips).  Every process runs the same program:

  1. ``initialize()``: the process group, NCCL on the card, gloo on the
     CPU;
  2. per-process ingest: ``host_record_indices()`` names the records the
     process's row positions need, ``encode_db_local()`` encodes only
     those (no process holds the whole database), ``assemble_global_db()``
     wraps the block as a ``ShardedDb``;
  3. ``SpiralServer(params, db, pub, mesh=global_mesh())`` serves as the
     single-process mesh path does (dist/shard.py): the first dimension
     needs no collective; one all-gather of a ciphertext per rank, then
     the replicated tail.

Launch, N processes on N cards of one host, either through torchrun
(which sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK;
``initialize()`` with no arguments reads them):

    torchrun --nproc-per-node N serve.py

or one process per card with the coordinator named, on each host:

    python serve.py   # calling initialize("host0:29500", N, <rank>)

where serve.py calls initialize() and then ingest_and_serve.
tests/test_torch_dist.py runs two gloo processes on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..params import Params
from ..server.db import ShardedDb, bitrev_perm, encode_rows
from .shard import db_axis, make_db_mesh


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda", **kw) -> None:
    """init_process_group for this process: `coordinator` "host:port" (the
    tcp:// rendezvous of rank 0), the world's size and this process's
    rank, with the backend of `device`.  With no coordinator it reads
    torchrun's environment (env://) where MASTER_ADDR is set, and makes a
    world of one on a free localhost port where it is not.  On the card
    the process takes card LOCAL_RANK (torchrun) or process_id, modulo the
    cards.  Further keywords go to init_process_group."""
    dev = torch.device(device)
    if coordinator is None and "MASTER_ADDR" not in os.environ:
        coordinator, num_processes, process_id = \
            f"localhost:{free_port()}", 1, 0
    if coordinator is None:
        kw["init_method"] = "env://"
        process_id = int(os.environ["RANK"])
    else:
        kw.update(init_method=f"tcp://{coordinator}",
                  world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)


@contextlib.contextmanager
def world(device="cuda"):
    """The initialized world for the block: the caller's, else one made by
    initialize() and destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    initialize(device=device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def global_mesh(device="cuda"):
    """1-D "db" mesh over every rank of the world."""
    return make_db_mesh(None, device)


def host_row_range(params: Params, num_processes: int,
                   process_id: int) -> tuple[int, int]:
    """[start, end) of the first-dimension row POSITIONS this process owns
    (positions index the bit-reversed serving layout, server/db.py)."""
    if params.num_per % num_processes:
        raise ValueError(
            f"num_per {params.num_per} not divisible by "
            f"{num_processes} processes")
    per = params.num_per // num_processes
    return process_id * per, (process_id + 1) * per


def host_record_indices(params: Params, num_processes: int,
                        process_id: int) -> np.ndarray:
    """Global record indices this process ingests, (dim0, rows_local):
    entry [j, r] is the record at local row position r for first-dimension
    index j.  Position pos holds further index bitrev(pos) (server/db.py),
    and record i = j*num_per + ii lives at (j, ii)."""
    r0, r1 = host_row_range(params, num_processes, process_id)
    ii = bitrev_perm(params.num_per)[r0:r1]          # (rows_local,)
    j = np.arange(params.dim0)[:, None]
    return j * params.num_per + ii[None, :]


def encode_db_local(pts_local: np.ndarray, params: Params,
                    device="cuda") -> torch.Tensor:
    """Encode this process's rows: pts_local (dim0, rows_local, n0, n2, d)
    ordered as host_record_indices, pts_local[j, r] =
    pts[host_record_indices(...)[j, r]] -> its (2, d, K, rows_local*n2)
    block of K2's layout on `device`.  encode_db's centring, lift and NTT
    without the bit reversal, which the record order already holds."""
    return encode_rows(pts_local, params, torch.device(device))


def assemble_global_db(local_block: torch.Tensor, params: Params,
                       mesh) -> ShardedDb:
    """This process's block as its share of the row-sharded database over
    the mesh's "db" axis.  Raises ValueError unless num_per divides by the
    mesh and the block is num_per*n2/world columns wide."""
    _, size, _ = db_axis(mesh)
    if params.num_per % size:
        raise ValueError(
            f"num_per {params.num_per} not divisible by mesh size {size}")
    width = params.num_per * params.n2 // size
    if local_block.shape[-1] != width:
        raise ValueError(f"a block of {local_block.shape[-1]} columns, want "
                         f"num_per*n2/{size} = {width}")
    return ShardedDb(data=local_block.contiguous(), params=params, mesh=mesh)


def ingest_and_serve(pts_provider, params: Params, pub,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda"):
    """Per-process setup end to end: fetch this process's records, encode,
    assemble, build the server over the global mesh.
    `pts_provider(record_indices)` returns the (dim0, rows_local, n0, n2,
    d) plaintext block, typically a read from the process's storage
    shard."""
    from ..pir import SpiralServer

    num_processes = num_processes or dist.get_world_size()
    process_id = dist.get_rank() if process_id is None else process_id
    mesh = global_mesh(device=device)
    idx = host_record_indices(params, num_processes, process_id)
    local = encode_db_local(pts_provider(idx), params, device)
    db = assemble_global_db(local, params, mesh)
    return SpiralServer(params, db, pub, mesh=mesh)
