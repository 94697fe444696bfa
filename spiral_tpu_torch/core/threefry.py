"""threefry2x32 and the jax.random calls the server replays (key from a
seed, split, randint over uint32), bit for bit as JAX 0.9 computes them
with jax_threefry_partitionable=True (jax/_src/prng.py threefry_seed,
_threefry_split_foldlike, _threefry_random_bits_partitionable;
jax/_src/random.py _randint).

Words are uint32 values held in int64 tensors; keys are python int pairs,
split on the host and copied to the device in one tensor (key_words).
random_bits draws each key of a set in one row, so a batch of queries
replays in one pass.
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


def key_words(key_sets: list[list[tuple[int, int]]], device) -> torch.Tensor:
    """S sets of B keys as the (S, 2, B, 1) int64 words random_bits takes,
    on `device`: one copy, sent non_blocking so that it does not sync the
    host.  Staged before a CUDA graph capture, they are the replay's
    input (the capture copies nothing from the host)."""
    w = torch.tensor([[[k[j] for k in keys] for j in (0, 1)]
                      for keys in key_sets], dtype=torch.int64)
    return w.to(device, non_blocking=True)[..., None]


def random_bits(words: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words over `shape` for each key of one set of
    key_words' words (2, B, 1): (B, *shape) int64, one key's stream per
    row."""
    n = math.prod(shape)
    assert n < (1 << 32)
    lo = torch.arange(n, dtype=torch.int64, device=words.device)
    b0, b1 = threefry2x32((words[0], words[1]), torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape((words.shape[1],) + tuple(shape))


def randint_keys(keys: list[tuple[int, int]]) -> list[list[tuple[int, int]]]:
    """The two key sets jax.random.randint draws from for each key: its
    high and its low words' keys."""
    halves = [split(k) for k in keys]
    return [[h[0] for h in halves], [h[1] for h in halves]]


def randint_u32(hi: torch.Tensor, lo: torch.Tensor, maxval: int):
    """jax.random.randint(key, shape, 0, maxval, dtype=uint32) from the
    random_bits of the key's two randint_keys sets, with its uint32
    wrap-around in the range reduction."""
    span, mult = maxval, randint_mult(maxval)
    off = ((hi % span) * mult & M32) + lo % span
    return (off & M32) % span


def randint_mult(maxval: int) -> int:
    """randint's multiplier for the high word: 2^32 mod maxval, as JAX
    forms it in uint32 ((2^16 mod maxval)^2 mod maxval)."""
    assert 0 < maxval <= M32
    mult = (1 << 16) % maxval
    return (mult * mult & M32) % maxval
