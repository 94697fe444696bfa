"""Randomness (counterpart of spiral_tpu/core/sampling.py).

Client noise comes from a torch.Generator on the CPU, so a seed gives the
same keys whatever device the client computes on; it does not reproduce
jax.random's bits.  ``uniform_residues_words`` of ``uniform_key_words`` is
the one sampler that must match JAX's uniform_residues bit for bit: the
server rebuilds query `a` halves with it (kernel K10 on the card, its
plain twin ``uniform_residues_words_plain`` on the CPU).
"""
from __future__ import annotations

import math
from functools import lru_cache

import torch

from .. import kernels
from ..params import B_I, P_I
from . import threefry

GAUSS_WIDTH = 6.4
NUM_WIDTHS = 10
MAX_VAL = int(math.ceil(GAUSS_WIDTH * NUM_WIDTHS))  # 64


@lru_cache(maxsize=None)
def _gauss_probs() -> torch.Tensor:
    i = torch.arange(-MAX_VAL, MAX_VAL + 1, dtype=torch.float64)
    return torch.exp(-math.pi * i ** 2 / GAUSS_WIDTH ** 2)


def gaussian_values(gen: torch.Generator, shape) -> torch.Tensor:
    """Discrete gaussian of width 6.4 on [-64, 64] (int64, CPU)."""
    n = math.prod(shape)
    idx = torch.multinomial(_gauss_probs(), n, replacement=True,
                            generator=gen)
    return (idx - MAX_VAL).reshape(shape)


def ternary_values(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, 3, tuple(shape), generator=gen) - 1


def uniform_residues(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform over Z_Q as independent residues: shape (..., d) ->
    (..., 2, d) int32 (CPU)."""
    x = torch.randint(0, P_I, tuple(shape), generator=gen)
    y = torch.randint(0, B_I, tuple(shape), generator=gen)
    return torch.stack([x, y], dim=-2).to(torch.int32)


def uniform_key_words(keys: list[tuple[int, int]], device) -> torch.Tensor:
    """The words of the four random_bits draws uniform_residues_words makes
    for each key (the residue mod P_I's high and low, then B_I's), as
    threefry.key_words gives them: (4, 2, len(keys), 1) on `device`."""
    halves = [threefry.split(k) for k in keys]
    return threefry.key_words(
        threefry.randint_keys([h[0] for h in halves]) +
        threefry.randint_keys([h[1] for h in halves]), device)


def uniform_residues_words(words: torch.Tensor, shape) -> torch.Tensor:
    """spiral_tpu.core.sampling.uniform_residues(jax key, shape) for each
    of B keys, from their uniform_key_words, bit for bit: (..., d) -> (B,
    ..., 2, d) int32.  One launch of kernel K10 (csrc/threefry.cu) on a
    CUDA tensor, uniform_residues_words_plain on the CPU."""
    if kernels.on_cpu(words):
        return uniform_residues_words_plain(words, shape)
    shape = tuple(shape)
    n = math.prod(shape)
    B = words.shape[2] if words.dim() == 4 else 0
    if words.dtype != torch.int64 or not words.is_contiguous() or \
            tuple(words.shape) != (4, 2, B, 1) or not shape or n >= 1 << 31:
        raise ValueError(
            f"K10: want contiguous int64 key words (4, 2, B, 1) and fewer "
            f"than 2^31 counters a query, got {words.dtype} "
            f"{tuple(words.shape)} and shape {shape}")
    out = torch.empty((B,) + shape[:-1] + (2, shape[-1]), dtype=torch.int32,
                      device=words.device)
    if B * n:
        kernels.check(kernels.lib().spiral_uniform_residues(
            words.data_ptr(), B, n, shape[-1], P_I, threefry.randint_mult(P_I),
            B_I, threefry.randint_mult(B_I), out.data_ptr(), kernels.stream()),
            "spiral_uniform_residues")
        kernels.LAUNCHES["threefry"] += 1
    return out


def uniform_residues_words_plain(words: torch.Tensor, shape) -> torch.Tensor:
    """uniform_residues_words in torch ops: four random_bits draws of
    int64 words and randint's range reduction."""
    x, y = (threefry.randint_u32(threefry.random_bits(words[i], shape),
                                 threefry.random_bits(words[i + 1], shape),
                                 maxval) for i, maxval in ((0, P_I), (2, B_I)))
    return torch.stack([x, y], dim=-2).to(torch.int32)
