"""CRT residue pair <-> value mod Q (counterpart of spiral_tpu/arith/crt.py).

Q = P_I * B_I < 2^56, so the Garner lift fits an int64 lane."""
from __future__ import annotations

import torch

from ..params import B_I, P_I, Q

P_INV_MOD_B = pow(P_I, B_I - 2, B_I)


def lift_pair(x, y):
    """Residues (x mod P_I, y mod B_I) -> int64 value in [0, Q)."""
    x = x.long()
    t = ((y.long() - x) % B_I) * P_INV_MOD_B % B_I
    return x + P_I * t


def const_residues(v: int) -> tuple[int, int]:
    v %= Q
    return v % P_I, v % B_I


def residues_from_values(v: torch.Tensor) -> torch.Tensor:
    """int64 values of any sign -> int32 residues, the (P_I, B_I) limb axis
    inserted before the last: (..., d) -> (..., 2, d)."""
    return torch.stack([v % P_I, v % B_I], dim=-2).to(torch.int32)
