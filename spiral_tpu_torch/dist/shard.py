"""Multi-device sharding of the server pipeline on torch.distributed
(counterpart of spiral_tpu/dist/shard.py).

A JAX ``Mesh`` becomes a ``torch.distributed.device_mesh.DeviceMesh`` with
a dimension named "db" over a process group, one process per device.  The
backend follows the rank's device: NCCL on the card, gloo on the CPU;
nothing falls back from one to the other.  Two layouts, as in the JAX
package:

* **Row sharding** (the serving default): rank r of w holds the columns of
  row positions [r*num_per/w, (r+1)*num_per/w) of K2's layout
  (server/db.py: column pos*n2 + c, position-major), a contiguous block.
  K2 then needs no collective; each rank folds its rows down to one
  survivor (rows are bit-reversed, so a round pairs adjacent columns and
  never crosses a rank), one all-gather stacks the w survivors in rank
  order, and the last log2(w) rounds run replicated on every rank.
  ``SpiralServer(..., mesh=)`` and ``PackServer(..., mesh=)`` use this.
  The port has one database layout, so the JAX package's row-major /
  limb-major distinction (its row_shard_spec warning) has no counterpart.
* **Contraction sharding**: rank r holds K rows [r*K/w, (r+1)*K/w); the
  NTT-domain K2 partials are summed by an exact modular all-reduce
  (``sharded_firstdim_and_fold``).

Expansion, composition and conversion work on query-sized data and run
replicated either way.  Every rank runs the same calls in the same order:
each collective here is entered by every rank of the mesh's "db" group.
``all_gather_tiled`` and ``psum_mod`` make no host sync, so on NCCL they
can sit inside a CUDA graph capture (the servers' graphs, graphs.py),
once the group's communicator exists: its first collective makes it,
and the servers' eager warm run before a capture is that collective.  A
graph holding one is itself a collective: every rank replays it, in the
same order.  gloo collectives cannot be captured.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..params import Params
from ..arith import ntt
from ..arith.mod import p_col
from ..server.firstdim import finish_output, multiply_query_by_db
from ..server.fold import fold_ciphertexts, fold_rounds, fold_rounds_batch

DB_AXIS = "db"


def make_db_mesh(n: int | None = None, device="cuda") -> DeviceMesh:
    """A 1-D mesh with the dimension "db" over ranks 0 .. n-1 of the
    initialized world (all of it when n is None).  Making a mesh is a
    collective: every rank of the world calls this, those it leaves out
    too."""
    world = dist.get_world_size()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    return DeviceMesh(torch.device(device).type, list(range(n)),
                      mesh_dim_names=(DB_AXIS,))


def db_axis(mesh: DeviceMesh):
    """The mesh's "db" dimension as this rank sees it: (its process group,
    its size, this rank's index along it)."""
    dim = mesh.mesh_dim_names.index(DB_AXIS)
    return (mesh.get_group(DB_AXIS), mesh.size(dim),
            mesh.get_local_rank(DB_AXIS))


def psum_mod(x: torch.Tensor, p, group) -> torch.Tensor:
    """Exact modular all-reduce of int32 residues below p < 2^28 over the
    group (p an int, or a tensor broadcasting against x): the residues are
    widened to int64, summed and reduced mod p.  A sum of w residues stays
    below 2^63 for any w below 2^35, so the JAX package's 16-bit split (it
    sums in u32) is not needed."""
    s = x.to(torch.int64, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(s, group=group)
    return (s % p).to(torch.int32)


def psum_mod_pair(x: torch.Tensor, group) -> torch.Tensor:
    """psum_mod over the CRT pair; x (..., 2, d), limb i mod (P_I, B_I)[i]."""
    return psum_mod(x, p_col(x.device), group)


def all_gather_tiled(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's x concatenated along `dim` in rank order (JAX's
    all_gather(..., tiled=True))."""
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((dist.get_world_size(group) * src.shape[0],) +
                      src.shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


# ---------------------------------------------------------------------------
# Row sharding: the per-rank program of SpiralServer / PackServer(mesh=)

def row_block(data: torch.Tensor, rows: int, world: int, rank: int,
              dim: int = -1) -> torch.Tensor:
    """Rank `rank` of `world`'s share of a tensor whose axis `dim` groups
    by `rows` rows (K2's columns: c to a row): rows [r*rows/w,
    (r+1)*rows/w) as a contiguous tensor (the tensor itself at world 1).
    Raises ValueError, as the JAX package does, when the rows do not
    divide by the world."""
    if rows % world:
        raise ValueError(f"DB row axis {rows} not divisible by mesh 'db' "
                         f"axis size {world}")
    width = data.shape[dim] // world
    return data.narrow(dim, rank * width, width).contiguous()


def shard_db_rows(data: torch.Tensor, rows: int,
                  mesh: DeviceMesh) -> torch.Tensor:
    """This rank's row_block on the mesh's "db" axis (the JAX
    shard_db_limbs): rows = num_per for Spiral's (2, d, K, num_per*n2),
    out_n^2 * num_per for the pack layout's (trial, position) columns."""
    _, world, rank = db_axis(mesh)
    return row_block(data, rows, world, rank)


class RankOf:
    """The "db" axis of rank `rank` in a world of `world`, with no process
    group: in place of a mesh it builds that rank's share of a server
    (SpiralServer / PackServer(..., mesh=RankOf(world, rank))), so that
    the ranks of a world can run one after another on one device.  Such a
    server runs the per-rank program (its first_dim / first_dim_batch,
    then fold_local / fold_local_batch); the caller stacks the survivors
    in rank order, as the all-gather would, and runs fold_tail /
    fold_tail_batch.  Its collectives (fold, process_query*) have no
    group to run on."""
    mesh_dim_names = (DB_AXIS,)

    def __init__(self, world: int, rank: int):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} in a world of {world}")
        self.world, self.rank = world, rank

    def get_group(self, name=None):
        return None

    def size(self, dim=None) -> int:
        return self.world

    def get_local_rank(self, name=None) -> int:
        return self.rank


def fold_local(cts: torch.Tensor, q_pos: torch.Tensor, q_neg: torch.Tensor,
               params: Params, g_buf: torch.Tensor | None = None
               ) -> torch.Tensor:
    """A rank's rows_local cts (its K2 block's, coefficient domain) -> its
    one survivor (1, n1, n2, 2, d): rounds 0 .. log2(rows_local) - 1, each
    K3 or K8b (fold.round_uses_mxu sees this rank's smaller rounds; the
    same rows)."""
    r_loc = cts.shape[0].bit_length() - 1
    return fold_rounds(cts, q_pos, q_neg, params, 0, r_loc, g_buf)


def fold_tail(survivors: torch.Tensor, q_pos: torch.Tensor,
              q_neg: torch.Tensor, params: Params,
              g_buf: torch.Tensor | None = None) -> torch.Tensor:
    """The world's survivors in rank order (world, n1, n2, 2, d) -> the
    final ct (n1, n2, 2, d): the last log2(world) rounds, from round
    log2(num_per / world), replicated on every rank."""
    r_loc = (params.num_per // survivors.shape[0]).bit_length() - 1
    return fold_ciphertexts(survivors, q_pos, q_neg, params,
                            start_round=r_loc, g_buf=g_buf)


def fold_sharded(cts: torch.Tensor, q_pos: torch.Tensor, q_neg: torch.Tensor,
                 params: Params, group,
                 g_buf: torch.Tensor | None = None) -> torch.Tensor:
    """A rank's rows_local cts -> the final ct, replicated: fold_local, one
    all-gather of the survivors in rank order, fold_tail (the JAX
    _fdim_fold_all, pir.py:258-266)."""
    surv = fold_local(cts, q_pos, q_neg, params, g_buf)
    return fold_tail(all_gather_tiled(surv, group), q_pos, q_neg, params,
                     g_buf)


def fold_local_batch(cts_b: torch.Tensor, q_pos_b: torch.Tensor,
                     q_neg_b: torch.Tensor, params: Params) -> torch.Tensor:
    """fold_local over a batch (B, rows_local, n1, n2, 2, d) -> the (B, 1,
    n1, n2, 2, d) survivors, on K5."""
    r_loc = cts_b.shape[1].bit_length() - 1
    return fold_rounds_batch(cts_b, q_pos_b, q_neg_b, params, 0, r_loc)


def fold_tail_batch(survivors_b: torch.Tensor, q_pos_b: torch.Tensor,
                    q_neg_b: torch.Tensor, params: Params) -> torch.Tensor:
    """fold_tail over a batch: (B, world, n1, n2, 2, d) in rank order ->
    (B, n1, n2, 2, d), on K5."""
    r_loc = (params.num_per // survivors_b.shape[1]).bit_length() - 1
    return fold_rounds_batch(survivors_b, q_pos_b, q_neg_b, params,
                             start_round=r_loc)[:, 0]


def fold_sharded_batch(cts_b: torch.Tensor, q_pos_b: torch.Tensor,
                       q_neg_b: torch.Tensor, params: Params,
                       group) -> torch.Tensor:
    """fold_sharded over a batch (B, rows_local, n1, n2, 2, d) -> (B, n1,
    n2, 2, d): fold_local_batch, one all-gather of the (B, world, ...)
    survivors, fold_tail_batch."""
    surv = fold_local_batch(cts_b, q_pos_b, q_neg_b, params)
    return fold_tail_batch(all_gather_tiled(surv, group, dim=1), q_pos_b,
                           q_neg_b, params)


# ---------------------------------------------------------------------------
# Contraction sharding (K psum)

def shard_db(data: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's K rows [k0, k1) of the (2, d, K, m) database, contiguous
    (the JAX shard_db's split of the contraction axis)."""
    _, world, rank = db_axis(mesh)
    return row_block(data, data.shape[2], world, rank, dim=2)


def sharded_firstdim_and_fold(params: Params, mesh: DeviceMesh):
    """-> step(db_k, query_k, q_pos, q_neg) -> the final ct (n1, n2, 2, d),
    coefficient domain, on every rank: K2 over this rank's K slice db_k
    (shard_db) and the matching rows of the replicated query_k (K, n1, 2,
    d), the NTT-domain partials summed by psum_mod_pair, the inverse NTT
    (K1), then fold_ciphertexts."""
    group, _, rank = db_axis(mesh)

    def step(db_k, query_k, q_pos, q_neg):
        k = db_k.shape[2]
        part = finish_output(
            multiply_query_by_db(db_k, query_k[rank * k:(rank + 1) * k]),
            params.num_per, params.n2)        # (num_per, n1, n2, 2, d)
        cts = ntt.inverse(psum_mod_pair(part, group))
        return fold_ciphertexts(cts, q_pos, q_neg, params)

    return step
