"""The plain client's randomness: discrete gaussians and uniform residues
from a torch.Generator on the CPU, and the jax.random threefry stream a
query's `a` halves are drawn from (JAX 0.9, jax_threefry_partitionable),
bit for bit, so that the server rebuilds them from the query's seed.

Frozen copy, at commit 1095982, of spiral_tpu_torch/core/threefry.py and
spiral_tpu_torch/core/sampling.py (gaussian_values, ternary_values,
uniform_residues, uniform_key_words, uniform_residues_words).
"""
from __future__ import annotations

import math
from functools import lru_cache

import torch

from .scheme import B_I, P_I

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
GAUSS_WIDTH = 6.4
MAX_VAL = int(math.ceil(GAUSS_WIDTH * 10))  # 64


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key, x0, x1):
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key_from_seed(seed: int) -> tuple[int, int]:
    """jax.random.key(seed) for a seed that fits int32."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"query seed {seed} does not fit int32")
    return 0, seed & M32


def split(key, num: int = 2):
    return [threefry2x32(key, 0, i) for i in range(num)]


def _key_words(key_sets, device) -> torch.Tensor:
    w = torch.tensor([[[k[j] for k in keys] for j in (0, 1)]
                      for keys in key_sets], dtype=torch.int64)
    return w.to(device)[..., None]


def _random_bits(words: torch.Tensor, shape) -> torch.Tensor:
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=words.device)
    b0, b1 = threefry2x32((words[0], words[1]), torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape((words.shape[1],) + tuple(shape))


def _randint_keys(keys):
    halves = [split(k) for k in keys]
    return [[h[0] for h in halves], [h[1] for h in halves]]


def _randint_u32(hi, lo, maxval: int):
    span = maxval
    mult = (1 << 16) % span
    mult = (mult * mult & M32) % span
    off = ((hi % span) * mult & M32) + lo % span
    return (off & M32) % span


def seed_uniform_residues(seeds, shape, device) -> torch.Tensor:
    """jax.random uniform_residues(key(seed), shape) for each seed:
    (B, *shape[:-1], 2, d) int32."""
    halves = [split(key_from_seed(int(s))) for s in seeds]
    words = _key_words(_randint_keys([h[0] for h in halves]) +
                       _randint_keys([h[1] for h in halves]), device)
    x, y = (_randint_u32(_random_bits(words[i], shape),
                         _random_bits(words[i + 1], shape), maxval)
            for i, maxval in ((0, P_I), (2, B_I)))
    return torch.stack([x, y], dim=-2).to(torch.int32)


@lru_cache(maxsize=None)
def _gauss_probs() -> torch.Tensor:
    i = torch.arange(-MAX_VAL, MAX_VAL + 1, dtype=torch.float64)
    return torch.exp(-math.pi * i ** 2 / GAUSS_WIDTH ** 2)


def gaussian_values(gen: torch.Generator, shape) -> torch.Tensor:
    """Discrete gaussian of width 6.4 on [-64, 64] (int64, CPU)."""
    idx = torch.multinomial(_gauss_probs(), math.prod(shape),
                            replacement=True, generator=gen)
    return (idx - MAX_VAL).reshape(shape)


def ternary_values(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, 3, tuple(shape), generator=gen) - 1


def uniform_residues(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform over Z_Q as residues: (..., d) -> (..., 2, d) int32 (CPU)."""
    x = torch.randint(0, P_I, tuple(shape), generator=gen)
    y = torch.randint(0, B_I, tuple(shape), generator=gen)
    return torch.stack([x, y], dim=-2).to(torch.int32)
