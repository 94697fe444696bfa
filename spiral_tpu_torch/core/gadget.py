"""Gadget matrices and digit decomposition (counterpart of
spiral_tpu/core/gadget.py).  Digits come from the int64 Garner lift of the
residue pair; the fold and expansion kernels (K3, K4) compute the same
digits in registers."""
from __future__ import annotations

from functools import lru_cache

import torch

from ..params import Q, get_bits_per
from ..arith.crt import const_residues, lift_pair
from ..arith.mod import MODS, p_col


def build_gadget(rows: int, cols: int, d: int, device) -> torch.Tensor:
    """G[i][i + j*rows] = z^j, z = 2^bits_per, coefficient domain
    (rows, cols, 2, d)."""
    assert cols % rows == 0
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


def _lifted_digits(x, num_elems: int, bits_per: int):
    """Unsigned base-2^bits_per digits of the lift of x (..., 2, d) ->
    list of int64 (..., d).  As in the JAX package, a digit wider than 31
    bits keeps only the low 32 bits of the shifted value."""
    v = lift_pair(x[..., 0, :], x[..., 1, :])
    mask = (1 << bits_per) - 1 if bits_per < 32 else 0xFFFFFFFF
    return [(v >> (k * bits_per)) & mask for k in range(num_elems)]


def gadget_invert_raw(x, mx: int, rdim: int):
    """Unsigned digit decomposition (gadget.py:74-91): x (..., rdim, m, 2, d)
    coefficient domain -> (..., mx, m, 2, d), out[j + k*rdim] = digit_k(x[j])."""
    assert x.shape[-4] == rdim and mx % rdim == 0
    num_elems = mx // rdim
    bits_per = get_bits_per(num_elems)
    p = p_col(x.device)
    rows = []
    for dg in _lifted_digits(x, num_elems, bits_per):
        r = torch.stack([dg, dg], dim=-2)
        rows.append(r if bits_per < 28 else r % p)
    return torch.cat(rows, dim=-4).to(torch.int32)


def signed_digits(x, num_elems: int):
    """Signed digits with carry as split_and_crt forms them (gadget.py:
    103-150): list over k of (piece, do_sign) int64/bool (..., d).  The
    digit's value is piece - z where do_sign holds, else piece."""
    bits_per = get_bits_per(num_elems)
    half_z = (1 << bits_per) // 2
    digs = _lifted_digits(x, num_elems, bits_per)
    out = []
    half = num_elems // 2
    for first, ks in ((True, range(half)), (False, range(half, num_elems))):
        carry = torch.zeros_like(digs[0])
        for k in ks:
            piece = digs[k] + carry
            do_sign = piece > half_z
            if first:
                do_sign &= k < half - 1
            carry = do_sign.long()
            out.append((piece, do_sign))
    return out


@lru_cache(maxsize=None)
def _sign_corr(z: int, device) -> torch.Tensor:
    """(Q - z) mod each modulus, (2, 1) int64 on `device`: made once per
    (z, device), as p_col is, so that no call copies it to the card."""
    return torch.tensor([[(Q - z) % m] for m in MODS], dtype=torch.int64,
                        device=device)


def gadget_invert_signed_raw(x, num_elems: int, rdim: int):
    """x (..., rdim, m, 2, d) -> (..., num_elems*rdim, m, 2, d), row
    j + k*rdim holding digit k of x[j] as residues."""
    assert x.shape[-4] == rdim
    p = p_col(x.device)
    corr = _sign_corr(1 << get_bits_per(num_elems), x.device)
    rows = []
    for piece, do_sign in signed_digits(x, num_elems):
        r = torch.stack([piece, piece], dim=-2) % p
        rows.append(torch.where(do_sign[..., None, :], (r + corr) % p, r))
    return torch.cat(rows, dim=-4).to(torch.int32)
