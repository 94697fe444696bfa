"""The CRT moduli and elementwise modular arithmetic on int64 tensors
(counterpart of spiral_tpu/arith/mod.py, whose u32-pair Barrett forms a
64-bit integer type makes unnecessary)."""
from __future__ import annotations

from functools import lru_cache

import torch

from ..params import B_I, P_I

MODS = (P_I, B_I)


@lru_cache(maxsize=None)
def p_col(device, dtype=torch.int64) -> torch.Tensor:
    """(2, 1) tensor of the moduli, broadcasting over (..., 2, d); made
    once per (device, dtype), since a copy to the card syncs the host.
    Callers only read it."""
    return torch.tensor([[P_I], [B_I]], dtype=dtype, device=device)


def add_mod(a, b, p):
    s = a + b
    return torch.where(s >= p, s - p, s)


def sub_mod(a, b, p):
    s = a - b
    return torch.where(s < 0, s + p, s)
