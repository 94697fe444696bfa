"""threefry2x32 and the jax.random calls the server replays (key from a
seed, split, randint over uint32), bit for bit as JAX 0.9 computes them
with jax_threefry_partitionable=True (jax/_src/prng.py threefry_seed,
_threefry_split_foldlike, _threefry_random_bits_partitionable;
jax/_src/random.py _randint).

Words are uint32 values held in int64 tensors; keys are python int pairs.
The samplers take a list of keys and draw each key's stream in one row, so
a batch of queries replays in one pass.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key: tuple[int, int], x0, x1):
    """The 20-round Threefry-2x32 hash of counter words (x0, x1)."""
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
    """jax.random.key(seed) for a seed that fits int32 (a python int, or
    the int32 scalar the JAX server passes): the high word is 0 and the
    low word is the seed's two's-complement bit pattern."""
    assert -(1 << 31) <= seed < (1 << 31)
    return 0, seed & M32


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    return [threefry2x32(key, 0, i) for i in range(num)]


def random_bits(keys: list[tuple[int, int]], shape, device) -> torch.Tensor:
    """32-bit random words over `shape` for each key: (len(keys), *shape)
    int64, one key's stream per row."""
    n = math.prod(shape)
    assert n < (1 << 32)
    # non_blocking: the copy of the keys to the card does not sync the host
    k0, k1 = (torch.tensor([k[j] for k in keys], dtype=torch.int64)
              .to(device, non_blocking=True)[:, None] for j in (0, 1))
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32((k0, k1), torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape((len(keys),) + tuple(shape))


def randint_u32(keys: list[tuple[int, int]], shape, maxval: int, device):
    """jax.random.randint(key, shape, 0, maxval, dtype=uint32) for each
    key, (len(keys), *shape), with its uint32 wrap-around in the range
    reduction."""
    span = maxval
    assert 0 < span <= M32
    halves = [split(k) for k in keys]
    hi = random_bits([h[0] for h in halves], shape, device)
    lo = random_bits([h[1] for h in halves], shape, device)
    mult = (1 << 16) % span
    mult = (mult * mult & M32) % span
    off = ((hi % span) * mult & M32) + lo % span
    return (off & M32) % span
