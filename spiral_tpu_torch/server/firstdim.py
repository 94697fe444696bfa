"""First-dimension multiply, the stage that streams the database
(counterpart of spiral_tpu/server/firstdim.py), for one query or a batch,
over an encoded database or an implicit one's slab.

out[limb, z, b, g, i*m + col] =
    sum_k Q_b[k, g, limb, (z - i) mod d] * DB[limb, z, k, col] mod p

Chunk i (the implicit mode: one slab streamed num_chunks times) multiplies
the database by the query rolled i NTT slots, as the JAX package's
multiply_query_by_db_implicit(_batch) does; one chunk is the ordinary
multiply.  On CUDA tensors every form is one call of kernel K2
(csrc/firstdim.cu), which replaces the Pallas first-dim kernel
(spiral_tpu/server/firstdim.py multiply_query_by_db_fused) and the XLA
multiply_query_by_db_mxu_batch / implicit loops: 8-bit limbs contracted
on the int8 tensor cores and recombined mod p; the database streams once
per chunk for the whole batch.  On the CPU they run
``multiply_plain`` / ``multiply_batch_plain``; ``multiply_limbs_plain``
models the kernel's arithmetic for the tests.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..arith.mod import p_col
from ..core.poly import MAC_CHUNK

# NTT slots per step of the plain multiply, bounding its int64 temporaries
SLOT_CHUNK = 64
# K2 splits words into N_LIMBS limbs of LIMB_BITS; each of its int32 sums
# has at most 4 K (2^LIMB_BITS - 1)^2 terms, so K <= K_MAX
LIMB_BITS = 8
N_LIMBS = 4
K_MAX = 8256


def reorient_query(cts: torch.Tensor) -> torch.Tensor:
    """dim0 matrix-Regev cts (..., dim0, n1, n0, 2, d) ->
    (..., K = dim0*n0, n1, 2, d)."""
    dim0, n1, n0 = cts.shape[-5:-2]
    return cts.transpose(-4, -3).reshape(
        cts.shape[:-5] + (dim0 * n0, n1) + cts.shape[-2:])


def multiply_plain(db: torch.Tensor, query_k: torch.Tensor) -> torch.Tensor:
    """db (2, d, K, m), query_k (K, n1, 2, d) -> (2, d, n1, m), as broadcast
    multiplies summed over at most MAC_CHUNK k at a time, SLOT_CHUNK NTT
    slots at a time."""
    crt, d, K, m = db.shape
    q = query_k.permute(2, 3, 0, 1).long()             # (2, d, K, n1)
    p = p_col(db.device)[:, :, None, None]             # (2, 1, 1, 1)
    out = []
    for z0 in range(0, d, SLOT_CHUNK):
        zs = slice(z0, z0 + SLOT_CHUNK)
        acc = 0
        for k0 in range(0, K, MAC_CHUNK):
            ks = slice(k0, k0 + MAC_CHUNK)
            prod = (q[:, zs, ks, :, None] *
                    db[:, zs, ks, None, :].long()).sum(dim=2)
            acc = (acc + prod % p) % p
        out.append(acc)
    return torch.cat(out, dim=1).to(torch.int32)


def multiply_batch_plain(db: torch.Tensor, query_k_b: torch.Tensor,
                         num_chunks: int = 1) -> torch.Tensor:
    """db (2, d, K, m), query_k_b (B, K, n1, 2, d) -> (2, d, B, n1,
    num_chunks*m): chunk i is ``multiply_plain`` of the queries rolled i
    slots (torch.roll along d), its columns at i*m."""
    B, K, n1, _, d = query_k_b.shape
    outs = []
    for i in range(num_chunks):
        q = torch.roll(query_k_b, i, dims=-1)
        outs.append(multiply_plain(
            db, q.transpose(0, 1).reshape(K, B * n1, 2, d)))
    return torch.cat(outs, dim=-1).reshape(2, d, B, n1, -1)


def multiply_limbs_plain(db: torch.Tensor, query_k_b: torch.Tensor,
                         num_chunks: int = 1,
                         prescaled: bool = False) -> torch.Tensor:
    """K2's arithmetic (csrc/firstdim.cu) in plain torch, for the tests:
    ``multiply_batch_plain``'s shapes, any 32-bit words (int32 tensors read
    as unsigned).  Both words split into four 8-bit limbs and the limb-pair
    products sum per weight s = i + j into seven groups S_s (the pair
    form), or the query's limbs are those of its prescaled residues
    Q_j = 2^(8j) q mod p and o_i = sum_(k, j) limb_i(Q_kj) x_kj (the
    prescaled form).  Each of K2's int32 sums is int64 here, asserted below
    2^31; then sum S_s (2^(8s) mod p), or sum o_i (2^(8i) mod p), mod p
    with Shoup products, each asserted in [0, 2p)."""
    crt, d, K, m = db.shape
    B, _, n1 = query_k_b.shape[:3]
    if K > K_MAX:
        raise ValueError(f"K = {K} > {K_MAX}: an int32 sum could overflow")
    mask = (1 << LIMB_BITS) - 1
    x = db.long() & 0xFFFFFFFF
    xl = [(x >> (LIMB_BITS * j)) & mask for j in range(N_LIMBS)]
    p = p_col(db.device)[:, :, None, None]               # (2, 1, 1, 1)

    def weight(s):
        return torch.remainder(torch.full_like(p, 1 << (LIMB_BITS * s)), p)

    outs = []
    for i_chunk in range(num_chunks):
        q = torch.roll(query_k_b, i_chunk, dims=-1).long() & 0xFFFFFFFF
        q = q.permute(3, 4, 0, 2, 1).reshape(crt, d, B * n1, K)
        if prescaled:
            Q = [q % p * weight(j) % p for j in range(N_LIMBS)]
            sums = [sum(((Q[j] >> (LIMB_BITS * i)) & mask) @ xl[j]
                        for j in range(N_LIMBS)) for i in range(N_LIMBS)]
        else:
            ql = [(q >> (LIMB_BITS * i)) & mask for i in range(N_LIMBS)]
            sums = [sum(ql[i] @ xl[s - i]
                        for i in range(max(0, s - N_LIMBS + 1),
                                       min(N_LIMBS, s + 1)))
                    for s in range(2 * N_LIMBS - 1)]
        acc = 0
        for s, S in enumerate(sums):
            assert int(S.max()) < 1 << 31, "an int32 sum of K2 overflows"
            w = weight(s)
            r = S * w - ((S * ((w << 32) // p)) >> 32) * p
            assert int(r.min()) >= 0 and bool((r < 2 * p).all())
            acc = acc + r
        outs.append(acc % p)
    out = torch.cat(outs, dim=-1).to(torch.int32)
    return out.reshape(crt, d, B, n1, num_chunks * m)


def multiply_query_by_db_batch(db: torch.Tensor, query_k_b: torch.Tensor,
                               num_chunks: int = 1,
                               first_chunk: int = 0) -> torch.Tensor:
    """db (2, d, K, m), query_k_b (B, K, n1, 2, d) -> (2, d, B, n1,
    num_chunks*m): chunks first_chunk .. first_chunk + num_chunks - 1 of an
    implicit slab (a rank's share of the chunks under a mesh).  The query
    is rolled first_chunk slots here, and chunk i rolls it i more (rolls
    add), so the kernel needs no chunk offset."""
    if first_chunk:
        query_k_b = torch.roll(query_k_b, first_chunk, dims=-1)
    if kernels.on_cpu(db, query_k_b):
        return multiply_batch_plain(db, query_k_b, num_chunks)
    crt, d, K, m = db.shape
    B, _, n1 = query_k_b.shape[:3]
    G = B * n1
    kernels.require(db, (2, d, K, m), "firstdim db")
    q = query_k_b.permute(3, 4, 1, 0, 2).reshape(2, d, K, G).contiguous()
    kernels.require(q, (2, d, K, G), "firstdim query")
    out = torch.empty((2, d, B, n1, num_chunks * m), dtype=torch.int32,
                      device=db.device)
    if n1 > 4 or K > K_MAX:
        raise ValueError(f"firstdim kernel takes n1 <= 4 and K <= {K_MAX}, "
                         f"got n1 {n1}, K {K}")
    kernels.check(kernels.lib().spiral_firstdim(
        db.data_ptr(), q.data_ptr(), out.data_ptr(), d, K, m, B, n1,
        num_chunks, kernels.stream()), "spiral_firstdim")
    kernels.LAUNCHES["firstdim"] += passes(B, K, n1)
    return out


def passes(B: int, K: int, n1: int) -> int:
    """K2's launches for B queries of n1 rows over K: one per pass of at
    most 16 queries and 64 rows (csrc/firstdim.cu)."""
    return -(-B // kernels.lib().spiral_firstdim_pass_queries(K, n1))


def multiply_query_by_db(db: torch.Tensor, query_k: torch.Tensor
                         ) -> torch.Tensor:
    """One query (K, n1, 2, d) -> (2, d, n1, m)."""
    return multiply_query_by_db_batch(db, query_k[None])[:, :, 0]


def multiply_query_by_db_implicit(slab: torch.Tensor, query_k: torch.Tensor,
                                  num_chunks: int) -> torch.Tensor:
    """The slab (2, d, K, m_slab) streamed num_chunks times for one query
    (K, n1, 2, d) -> (2, d, n1, num_chunks*m_slab)."""
    return multiply_query_by_db_batch(slab, query_k[None], num_chunks)[:, :, 0]


def multiply_query_by_db_implicit_batch(slab: torch.Tensor,
                                        query_k_b: torch.Tensor,
                                        num_chunks: int) -> torch.Tensor:
    """(B, K, n1, 2, d) -> (2, d, B, n1, num_chunks*m_slab)."""
    return multiply_query_by_db_batch(slab, query_k_b, num_chunks)


def finish_output(res: torch.Tensor, num_per: int, n2: int) -> torch.Tensor:
    """(2, d, n1, num_per*n2) -> (num_per, n1, n2, 2, d)."""
    crt, d, n1, _ = res.shape
    return res.reshape(crt, d, n1, num_per, n2).permute(3, 2, 4, 0, 1)


def finish_output_batch(res: torch.Tensor, num_per: int,
                        n2: int) -> torch.Tensor:
    """(2, d, B, n1, num_per*n2) -> (B, num_per, n1, n2, 2, d)."""
    crt, d, B, n1, _ = res.shape
    return res.reshape(crt, d, B, n1, num_per, n2).permute(2, 4, 3, 5, 0, 1)
