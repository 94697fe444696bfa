"""Database generation and encoding (counterpart of spiral_tpu/server/db.py).

The port keeps the encoded database in the layout the first-dimension
kernel K2 streams:

    data[limb, z, j*n0 + r, pos*n2 + c]       (2, d, K = dim0*n0, m = num_per*n2)

with NTT slot z and CRT limb outermost, so one (limb, z) slice is a
contiguous K x m matrix and each k row of it is m consecutive residues
(coalesced loads across a warp).  Further-index ii sits at row position
pos = bitrev(ii), as in the JAX layout (num_per, n2, K, 2, d), so fold
rounds pair adjacent ciphertexts.

An ``ImplicitDb`` (the implicit huge-database mode) holds one random slab
in the same layout, streamed num_chunks times by the first-dim multiply.
A ``ShardedDb`` holds one rank's column block of a row-sharded database
(dist/), the columns of its row positions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..params import B_I, P_I, Params
from ..arith import ntt
from ..arith.crt import residues_from_values

# database polys NTT'd per upload block of encode_db and encode_pack_db
BLOCK_POLYS = 32768


@dataclasses.dataclass
class EncodedDb:
    data: torch.Tensor    # (2, d, dim0*n0, num_per*n2) int32, NTT domain
    params: Params


@dataclasses.dataclass
class ShardedDb:
    """One rank's share of a row-sharded database (counterpart of
    spiral_tpu/server/db.py ShardedLimbsDb): the contiguous (2, d, K,
    rows_local*n2) block of K2's layout holding row positions [r0, r1)
    (dist/multihost.py host_row_range), built by each rank from its own
    records (multihost.assemble_global_db); the mesh it is sharded over."""
    data: torch.Tensor    # (2, d, dim0*n0, rows_local*n2) int32, NTT domain
    params: Params
    mesh: object          # torch.distributed.device_mesh.DeviceMesh


@dataclasses.dataclass
class ImplicitDb:
    """Implicit huge-database mode (counterpart of spiral_tpu/server/db.py
    ImplicitDb; ref --random-data): a random NTT-domain slab covering
    `slab_per` first-dimension rows, streamed `num_chunks` times by the
    first-dim multiply, so the server does the work of a database of
    slab_per * num_chunks rows without holding it.  Its answers do not
    decode, by design."""
    slab: torch.Tensor    # (2, d, K, slab_per*n2) int32, K2's layout
    slab_per: int
    num_chunks: int
    params: Params


def _random_slab(rng: np.random.Generator, rows: int, n2: int, K: int,
                 d: int, device) -> torch.Tensor:
    """The JAX slab draws, in its order: residues mod P_I over (rows, n2,
    K, d), then mod B_I; written as (2, d, K, rows*n2), column row*n2 + c
    (no bit reversal: the slab is random)."""
    out = torch.empty((2, d, K, rows * n2), dtype=torch.int32, device=device)
    for li, p in enumerate((P_I, B_I)):
        x = rng.integers(0, p, size=(rows, n2, K, d), dtype=np.uint64)
        t = torch.from_numpy(x.astype(np.int32)).to(device)
        out[li] = t.permute(3, 2, 0, 1).reshape(d, K, rows * n2)
    return out


def slab_rows(rows: int, row_bytes: int, max_slab_bytes: int) -> int:
    """The largest divisor of `rows` within max_slab_bytes (at least 1)."""
    n = max(1, min(rows, max_slab_bytes // row_bytes))
    while rows % n:
        n -= 1
    return n


def random_implicit_db(params: Params, rng: np.random.Generator,
                       max_slab_bytes: int = 2 << 30,
                       device="cuda") -> ImplicitDb:
    """Spiral's implicit database: the slab's rows are further-index
    positions; the same draws and sizing as spiral_tpu's
    random_implicit_db (4 bytes per residue, as its int8 limbs)."""
    num_per, n2, d = params.num_per, params.n2, params.poly_len
    K = params.dim0 * params.n0
    slab_per = slab_rows(num_per, n2 * K * 2 * d * 4, max_slab_bytes)
    return ImplicitDb(_random_slab(rng, slab_per, n2, K, d, device),
                      slab_per, num_per // slab_per, params)


def random_implicit_pack_db(params: Params, rng: np.random.Generator,
                            max_slab_bytes: int = 2 << 30,
                            device="cuda") -> ImplicitDb:
    """The pack variant's implicit database: rows are the (trial, num_per)
    groups of the pack layout, trial-major, as spiral_tpu's
    random_implicit_pack_db draws them."""
    d, K = params.poly_len, params.dim0
    rows = params.out_n ** 2 * params.num_per
    per = slab_rows(rows, K * 2 * d * 4, max_slab_bytes)
    return ImplicitDb(_random_slab(rng, per, 1, K, d, device), per,
                      rows // per, params)


def bitrev_perm(n: int) -> np.ndarray:
    """perm[pos] = further index stored at pos (bit reversal, an involution)."""
    bits = n.bit_length() - 1
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        out[i] = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
    return out


def random_db(params: Params, rng: np.random.Generator) -> np.ndarray:
    """Host plaintexts (total_n, n0, n2, d) in [0, p_db); the same draws as
    spiral_tpu.server.db.random_db for the same generator state."""
    return rng.integers(
        0, params.p_db,
        size=(params.total_n, params.n0, params.n2, params.poly_len),
        dtype=np.int64)


def encode_rows(pts_rows: np.ndarray, params: Params, device,
                perm: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Host plaintexts (dim0, rows, n0, n2, d) -> K2's layout (2, d,
    dim0*n0, rows*n2): centred mod p_db, lifted and NTT'd on `device`, one
    block of first-dimension indices at a time (a block uploads as int16
    when p_db allows).  Row position pos holds pts_rows[:, perm[pos]], or
    pts_rows[:, pos] without `perm`.  `out`, a view of that shape on
    `device`, takes the encoding in place of a new tensor."""
    p_db, d = params.p_db, params.poly_len
    dim0, rows, n0, n2 = pts_rows.shape[:4]
    small = np.int16 if p_db <= (1 << 15) else np.int32
    shape = (2, d, dim0 * n0, rows * n2)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=device)
    elif tuple(out.shape) != shape:
        raise ValueError(f"encode_db out {tuple(out.shape)}, want {shape}")
    jb = max(1, min(dim0, BLOCK_POLYS // (rows * n0 * n2)))
    for j0 in range(0, dim0, jb):
        j1 = min(dim0, j0 + jb)
        block = pts_rows[j0:j1].reshape((j1 - j0) * rows, n0, n2, d)
        centered = np.where(block >= p_db // 2, block - p_db, block)
        c = torch.from_numpy(centered.astype(small)).to(device).long()
        t = ntt.forward(residues_from_values(c))   # (nb*rows, n0, n2, 2, d)
        t = t.reshape(j1 - j0, rows, n0, n2, 2, d)
        if perm is not None:
            t = t[:, perm]
        out[:, :, j0 * n0:j1 * n0] = t.permute(4, 5, 0, 2, 1, 3).reshape(
            2, d, (j1 - j0) * n0, rows * n2)
    return out


def encode_db(pts: np.ndarray, params: Params, device,
              out: torch.Tensor | None = None) -> EncodedDb:
    """Center mod p_db, lift, NTT on `device`, and write the K2 layout
    (encode_rows), further index ii at row position bitrev(ii).  `out`, a
    (2, d, K, num_per*n2) view on `device`, takes the encoding in place of
    a new tensor (a factored database's column block).  Traced as one
    spiral.encode span (host time: the last block's work may still run on
    the card when it ends); tracing.COUNTS["encoded_bytes"] adds the bytes
    it writes."""
    p = params
    with tracing.span("encode"):
        perm = torch.from_numpy(bitrev_perm(p.num_per)).to(device)
        rows = pts.reshape(p.dim0, p.num_per, p.n0, p.n2, p.poly_len)
        data = encode_rows(rows, p, device, perm, out)
    tracing.COUNTS["encoded_bytes"] += data.numel() * data.element_size()
    return EncodedDb(data=data, params=params)
