"""Ring-element matrix algebra on int32 residue tensors (..., rows, cols, 2, d)
(counterpart of spiral_tpu/core/poly.py; plain torch, no kernel).

Sums of residues stay below 2^29 and fit int32; products widen to int64.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..arith.crt import const_residues
from ..arith.mod import p_col

# products are < 2^56, so up to 128 of them sum below 2^63
MAC_CHUNK = 128


def add_raw(a, b):
    p = p_col(a.device, torch.int32)
    s = a + b
    return torch.where(s >= p, s - p, s)


def sub_raw(a, b):
    p = p_col(a.device, torch.int32)
    s = a - b
    return torch.where(s < 0, s + p, s)


def neg_raw(a):
    p = p_col(a.device, torch.int32)
    return torch.where(a == 0, a, p - a)


def scalar_mul_raw(sp, a):
    """Every poly of `a` times the single poly `sp` (..., 2, d), NTT domain."""
    p = p_col(a.device)
    return (a.long() * sp.long() % p).to(torch.int32)


def matmul_raw(a, b):
    """NTT-domain matrix product: a (..., R, M, 2, d) @ b (..., M, C, 2, d)
    -> (..., R, C, 2, d), as a broadcast multiply and a sum over M reduced
    mod p every MAC_CHUNK terms (torch has no int64 matmul on CUDA)."""
    M = a.shape[-3]
    assert b.shape[-4] == M, (a.shape, b.shape)
    p = p_col(a.device)
    acc = None
    for m0 in range(0, M, MAC_CHUNK):
        sl = slice(m0, min(m0 + MAC_CHUNK, M))
        prod = (a[..., :, sl, None, :, :].long() *
                b[..., None, sl, :, :, :].long()).sum(dim=-4) % p
        acc = prod if acc is None else (acc + prod) % p
    return acc.to(torch.int32)


@lru_cache(maxsize=None)
def _automorph_tables(d: int, t: int, device: str):
    """Gather indices and negation mask for x -> x^t (poly.py:126-135), on
    `device`: made and copied there once per (d, t, device)."""
    i = np.arange(d)
    src = np.zeros(d, dtype=np.int64)
    neg = np.zeros(d, dtype=bool)
    src[(i * t) % d] = i
    neg[(i * t) % d] = ((i * t) // d) % 2 == 1
    return torch.from_numpy(src).to(device), torch.from_numpy(neg).to(device)


def automorph_raw(a, t: int):
    """tau_t in the coefficient domain: out[(i*t) mod d] = +/- a[i]."""
    src, neg = _automorph_tables(a.shape[-1], t, str(a.device))
    v = a[..., src]
    return torch.where(neg, neg_raw(v), v)


def monomial(coef: int, idx: int, d: int, device) -> torch.Tensor:
    """1x1 coefficient-domain poly coef * x^idx (PolyMat.monomial)."""
    out = torch.zeros((1, 1, 2, d), dtype=torch.int32, device=device)
    x, y = const_residues(coef)
    out[0, 0, 0, idx] = x
    out[0, 0, 1, idx] = y
    return out
