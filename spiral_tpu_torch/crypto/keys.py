"""Secret keys (counterpart of spiral_tpu/crypto/keys.py): Sp, an n x k
small matrix, and the scalar Regev secret sr, both coefficient domain.  The
Spiral client uses n = n0, k = n1 - n0; the pack client n = out_n, k = 1."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..params import Params
from ..arith.crt import residues_from_values
from ..core.sampling import gaussian_values, ternary_values


@dataclasses.dataclass
class SecretKeys:
    Sp: torch.Tensor          # (n, k, 2, d) int32, coeff
    sr: torch.Tensor          # (1, 1, 2, d) int32, coeff
    Sp_centered: np.ndarray   # (n, k, d) int64
    sr_centered: np.ndarray   # (d,) int64


def _sample_small(gen, shape, ternary: bool, nonoise: bool) -> torch.Tensor:
    if nonoise:
        return torch.zeros(shape, dtype=torch.int64)
    return (ternary_values if ternary else gaussian_values)(gen, shape)


def keygen(params: Params, gen: torch.Generator, device,
           n_val: int | None = None, k: int | None = None,
           nonoise: bool = False) -> SecretKeys:
    n = params.n0 if n_val is None else n_val
    k = params.k_param if k is None else k
    d = params.poly_len
    sp = _sample_small(gen, (n, k, d), params.ternary, nonoise)
    sr = _sample_small(gen, (1, 1, d), params.ternary, nonoise)
    return SecretKeys(Sp=residues_from_values(sp).to(device),
                      sr=residues_from_values(sr).to(device),
                      Sp_centered=sp.numpy(), sr_centered=sr[0, 0].numpy())
