"""Negacyclic NTT tables (host numpy): the plain radix-2 NTT's and the
CUDA kernels' register NTT's, in the JAX ``mxu`` slot order (counterpart
of spiral_tpu/arith/tables.py, which cannot be imported without jax).

The transform is x -> X with X[k] = sum_i x_i psi^{(2k+1) i}, psi the
primitive 2d-th root of unity g^{(p-1)/2d} for the smallest primitive root
g of p (the root both JAX engines use).  The radix-2 decimation-in-
frequency network leaves X[bitrev(pos)] at position pos; the JAX ``mxu``
four-step engine (spiral_tpu/arith/ntt_mxu.py, d = d1*d2) stores X[d1*e + c]
at slot c*d2 + e.  ``pos_of_slot`` maps one order onto the other.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from .mod import MODS

# rows of NttTables.packed (reg::ROW_POS and reg::ROW_REG in ntt_reg.cuh)
ROW_POS, ROW_REG = 0, 1


def _factorize(n: int) -> list[int]:
    fs, f = [], 2
    while f * f <= n:
        if n % f == 0:
            fs.append(f)
            while n % f == 0:
                n //= f
        f += 1
    if n > 1:
        fs.append(n)
    return fs


def primitive_root(p: int) -> int:
    phi = p - 1
    fs = _factorize(phi)
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


def bitrev(n_bits: int, n: int) -> np.ndarray:
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(n_bits):
        out |= ((idx >> b) & 1) << (n_bits - 1 - b)
    return out


@dataclasses.dataclass(frozen=True)
class NttTables:
    """Tables for one ring degree d, both moduli stacked on axis 0."""

    d: int
    twist: np.ndarray        # (2, d) psi^i
    untwist: np.ndarray      # (2, d) d^{-1} psi^{-i}
    omega: np.ndarray        # (2, d) omega^k (k < d/2 used), omega = psi^2
    omega_inv: np.ndarray    # (2, d) omega^{-k}
    pos_of_slot: np.ndarray  # (d,) mxu slot j -> radix-2 output position
    slot_of_pos: np.ndarray  # (d,) inverse permutation
    psi_rev: np.ndarray      # (2, d) psi^bitrev(k)
    psi_inv_rev: np.ndarray  # (2, d) psi^-bitrev(k); entry 0 holds d^{-1}

    def packed(self) -> np.ndarray:
        """(9, d) int32 table the CUDA kernels read (csrc/ntt_reg.cuh), u32
        bit patterns: row ROW_POS pos_of_slot; rows ROW_REG + li*4 + r for
        r = psi_rev, its Shoup companions, psi_inv_rev, its companions."""
        rows = [self.pos_of_slot]
        for li, p in enumerate(MODS):
            rows += [self.psi_rev[li], shoup(self.psi_rev[li], p),
                     self.psi_inv_rev[li], shoup(self.psi_inv_rev[li], p)]
        return np.stack(rows).astype(np.uint32).view(np.int32)


def shoup(w: np.ndarray, p: int) -> np.ndarray:
    """Shoup companions floor(w * 2^32 / p) of residues w < p < 2^31."""
    return (np.asarray(w, dtype=np.int64) << 32) // p


def mxu_split(d: int) -> tuple[int, int]:
    """(d1, d2) of the JAX four-step engine (FourStepNtt.__init__)."""
    L = d.bit_length() - 1
    d1 = 1 << ((L + 1) // 2)
    return d1, d // d1


@lru_cache(maxsize=None)
def ntt_tables(d: int) -> NttTables:
    assert d & (d - 1) == 0 and d >= 4
    L = d.bit_length() - 1
    tw, utw, om, omi, prev, pirev = [], [], [], [], [], []
    rev = bitrev(L, d)
    for p in MODS:
        assert (p - 1) % (2 * d) == 0
        psi = pow(primitive_root(p), (p - 1) // (2 * d), p)
        psi_inv = pow(psi, p - 2, p)
        d_inv = pow(d, p - 2, p)
        tw.append(_powers(psi, d, p))
        utw.append(_powers(psi_inv, d, p) * d_inv % p)
        om.append(_powers(psi * psi % p, d, p))
        omi.append(_powers(psi_inv * psi_inv % p, d, p))
        prev.append(tw[-1][rev])
        pirev.append(_powers(psi_inv, d, p)[rev])
        pirev[-1][0] = d_inv
    d1, d2 = mxu_split(d)
    j = np.arange(d)
    k = d1 * (j % d2) + j // d2
    pos_of_slot = bitrev(L, d)[k]
    slot_of_pos = np.empty(d, dtype=np.int64)
    slot_of_pos[pos_of_slot] = j
    return NttTables(d=d, twist=np.stack(tw), untwist=np.stack(utw),
                     omega=np.stack(om), omega_inv=np.stack(omi),
                     pos_of_slot=pos_of_slot, slot_of_pos=slot_of_pos,
                     psi_rev=np.stack(prev), psi_inv_rev=np.stack(pirev))
