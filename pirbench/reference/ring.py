"""Ring arithmetic of the plain client: residue pairs mod (P_I, B_I),
polynomial matrices (..., rows, cols, 2, d), the negacyclic NTT in the JAX
``mxu`` slot order the wire uses, and the gadget matrix.  Plain torch on
any device, no kernel.

Frozen copy, at commit 1095982, of spiral_tpu_torch/arith/crt.py
(residues_from_values), arith/mod.py, arith/tables.py (the plain
transform's tables), arith/ntt.py (forward_plain, inverse_plain),
core/poly.py (add_raw, neg_raw, scalar_mul_raw, matmul_raw, automorph_raw)
and core/gadget.py (build_gadget).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .scheme import B_I, P_I, Q, get_bits_per

MODS = (P_I, B_I)
MAC_CHUNK = 128


def residues_from_values(v: torch.Tensor) -> torch.Tensor:
    """int64 values of any sign -> int32 residues (..., d) -> (..., 2, d)."""
    return torch.stack([v % P_I, v % B_I], dim=-2).to(torch.int32)


def const_residues(v: int) -> tuple[int, int]:
    v %= Q
    return v % P_I, v % B_I


@lru_cache(maxsize=None)
def p_col(device, dtype=torch.int64) -> torch.Tensor:
    return torch.tensor([[P_I], [B_I]], dtype=dtype, device=device)


def _add_mod(a, b, p):
    s = a + b
    return torch.where(s >= p, s - p, s)


def _sub_mod(a, b, p):
    s = a - b
    return torch.where(s < 0, s + p, s)


def add_raw(a, b):
    return _add_mod(a, b, p_col(a.device, torch.int32))


def neg_raw(a):
    p = p_col(a.device, torch.int32)
    return torch.where(a == 0, a, p - a)


def scalar_mul_raw(sp, a):
    return (a.long() * sp.long() % p_col(a.device)).to(torch.int32)


def matmul_raw(a, b):
    """(..., R, M, 2, d) @ (..., M, C, 2, d) -> (..., R, C, 2, d), NTT
    domain."""
    M = a.shape[-3]
    p = p_col(a.device)
    acc = None
    for m0 in range(0, M, MAC_CHUNK):
        sl = slice(m0, min(m0 + MAC_CHUNK, M))
        prod = (a[..., :, sl, None, :, :].long() *
                b[..., None, sl, :, :, :].long()).sum(dim=-4) % p
        acc = prod if acc is None else (acc + prod) % p
    return acc.to(torch.int32)


def automorph_raw(a, t: int):
    """tau_t in the coefficient domain: out[(i*t) mod d] = +/- a[i]."""
    d = a.shape[-1]
    i = np.arange(d)
    src = np.zeros(d, dtype=np.int64)
    neg = np.zeros(d, dtype=bool)
    src[(i * t) % d] = i
    neg[(i * t) % d] = ((i * t) // d) % 2 == 1
    v = a[..., torch.from_numpy(src).to(a.device)]
    return torch.where(torch.from_numpy(neg).to(a.device), neg_raw(v), v)


def _primitive_root(p: int) -> int:
    phi, fs, n, f = p - 1, [], p - 1, 2
    while f * f <= n:
        if n % f == 0:
            fs.append(f)
            while n % f == 0:
                n //= f
        f += 1
    if n > 1:
        fs.append(n)
    g = 2
    while not all(pow(g, phi // q, p) != 1 for q in fs):
        g += 1
    return g


def _powers(base: int, n: int, p: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    cur = 1
    for i in range(n):
        out[i] = cur
        cur = cur * base % p
    return out


def _bitrev(n_bits: int, n: int) -> np.ndarray:
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(n_bits):
        out |= ((idx >> b) & 1) << (n_bits - 1 - b)
    return out


@lru_cache(maxsize=None)
def _tables(d: int, device: str):
    """twist, untwist, omega, omega_inv (2, d) and the mxu slot maps."""
    L = d.bit_length() - 1
    tw, utw, om, omi = [], [], [], []
    for p in MODS:
        psi = pow(_primitive_root(p), (p - 1) // (2 * d), p)
        psi_inv = pow(psi, p - 2, p)
        d_inv = pow(d, p - 2, p)
        tw.append(_powers(psi, d, p))
        utw.append(_powers(psi_inv, d, p) * d_inv % p)
        om.append(_powers(psi * psi % p, d, p))
        omi.append(_powers(psi_inv * psi_inv % p, d, p))
    d1 = 1 << ((L + 1) // 2)
    d2 = d // d1
    j = np.arange(d)
    pos_of_slot = _bitrev(L, d)[d1 * (j % d2) + j // d2]
    slot_of_pos = np.empty(d, dtype=np.int64)
    slot_of_pos[pos_of_slot] = j
    as_t = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    return (as_t(np.stack(tw)), as_t(np.stack(utw)), as_t(np.stack(om)),
            as_t(np.stack(omi)), as_t(pos_of_slot), as_t(slot_of_pos))


def ntt_forward(x: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT, natural order in, mxu slot order out."""
    d = x.shape[-1]
    L = d.bit_length() - 1
    twist, _, omega, _, pos_of_slot, _ = _tables(d, str(x.device))
    p = p_col(x.device)
    p3 = p[:, :, None]
    a = x.long() * twist % p
    for s in range(L):
        t = d >> (s + 1)
        w = omega[:, ::1 << s][:, None, :t]
        v = a.reshape(a.shape[:-1] + (1 << s, 2, t))
        l, r = v[..., 0, :], v[..., 1, :]
        a = torch.stack([_add_mod(l, r, p3), _sub_mod(l, r, p3) * w % p3],
                        dim=-2).reshape(a.shape)
    return a[..., pos_of_slot].to(torch.int32)


def ntt_inverse(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    L = d.bit_length() - 1
    _, untwist, _, omega_inv, _, slot_of_pos = _tables(d, str(x.device))
    p = p_col(x.device)
    p3 = p[:, :, None]
    a = x.long()[..., slot_of_pos]
    for s in range(L - 1, -1, -1):
        t = d >> (s + 1)
        w = omega_inv[:, ::1 << s][:, None, :t]
        v = a.reshape(a.shape[:-1] + (1 << s, 2, t))
        bw = v[..., 1, :] * w % p3
        a = torch.stack([_add_mod(v[..., 0, :], bw, p3),
                         _sub_mod(v[..., 0, :], bw, p3)],
                        dim=-2).reshape(a.shape)
    return (a * untwist % p).to(torch.int32)


def build_gadget(rows: int, cols: int, d: int, device) -> torch.Tensor:
    """G[i][i + j*rows] = 2^(bits_per*j), coefficient domain."""
    num_elems = cols // rows
    bits_per = get_bits_per(num_elems)
    out = torch.zeros((rows, cols, 2, d), dtype=torch.int32)
    for i in range(rows):
        for j in range(num_elems):
            if bits_per * j >= 64:
                continue
            x, y = const_residues(1 << (bits_per * j))
            out[i, i + j * rows, 0, 0] = x
            out[i, i + j * rows, 1, 0] = y
    return out.to(device)
