"""The server's threefry replay against jax.random: the query's `a` halves
must be rebuilt bit for bit from the seed."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spiral_tpu.crypto.query import derive_a_ntt as j_derive
from spiral_tpu_torch.core import sampling, threefry
from spiral_tpu_torch.crypto.query import (derive_a_ntt, derive_a_ntt_batch,
                                           seed_words)
from spiral_tpu_torch.params import B_I, P_I

SEEDS = [0, 1, 987654, 2**31 - 1, -1, -(2**31), -123456789]


@pytest.mark.parametrize("seed", SEEDS)
def test_derive_a_ntt_matches_jax(seed):
    got = derive_a_ntt(seed, 2, 256, "cpu")
    want = j_derive(jnp.int32(seed), 2, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", [3, -3])
def test_key_and_split_match_jax(seed):
    key = jax.random.key(jnp.int32(seed))
    assert threefry.key_from_seed(seed) == tuple(
        int(v) for v in np.asarray(jax.random.key_data(key)))
    want = [tuple(int(v) for v in row)
            for row in np.asarray(jax.random.key_data(jax.random.split(key)))]
    assert threefry.split(threefry.key_from_seed(seed)) == want


# several seeds in one pass, as a served batch replays them
@pytest.mark.parametrize("seeds", [[0, -1, 2**31 - 1],
                                   [-(2**31), 987654, -123456789],
                                   [1, -7, 2**30]])
def test_derive_a_ntt_batch_matches_jax(seeds):
    got = derive_a_ntt_batch(seeds, 2, 2048, "cpu")
    assert got.shape == (3, 2, 1, 1, 2, 2048)
    for row, seed in zip(got, seeds):
        want = j_derive(jnp.int32(seed), 2, 2048)
        np.testing.assert_array_equal(row.numpy(),
                                      np.asarray(want).astype(np.int64))


def _k10_model(words: np.ndarray, shape) -> np.ndarray:
    """csrc/threefry.cu in numpy uint32: a thread's hashes, its randint
    reduction in 32-bit wrap-around and its two stores, for every (query,
    counter) pair, into the flat output."""
    u32 = np.uint32
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))

    def bits(k0, k1, i):
        ks = (u32(k0), u32(k1), u32(k0) ^ u32(k1) ^ u32(0x1BD11BDA))
        x0, x1 = np.full_like(i, ks[0]), i + ks[1]
        for r in range(5):
            for j in range(4):
                x0 = x0 + x1
                s = rot[r % 2][j]
                x1 = ((x1 << u32(s)) | (x1 >> u32(32 - s))) ^ x0
            x0 = x0 + ks[(r + 1) % 3]
            x1 = x1 + ks[(r + 2) % 3] + u32(r + 1)
        return x0 ^ x1

    def randint(hi, lo, span):
        span, mult = u32(span), u32(threefry.randint_mult(int(span)))
        return ((hi % span) * mult + lo % span) % span

    n, d, B = math.prod(shape), shape[-1], words.shape[2]
    k = words.reshape(8, B).astype(u32)
    i = np.arange(n, dtype=u32)
    out = np.zeros(B * n * 2, dtype=np.int64)
    with np.errstate(over="ignore"):
        for b in range(B):
            x = randint(bits(k[0, b], k[1, b], i), bits(k[2, b], k[3, b], i),
                        P_I)
            y = randint(bits(k[4, b], k[5, b], i), bits(k[6, b], k[7, b], i),
                        B_I)
            row = (b * (n // d) + i // d) * 2 * d + i % d
            out[row], out[row + d] = x, y
    return out


@pytest.mark.parametrize("shape", [(1, 1, 1, 256), (3, 1, 1, 64)])
def test_k10_model_matches_plain(shape):
    """The kernel's uint32 arithmetic and store layout, modelled in numpy,
    against the int64 twin uniform_residues_words_plain: seeds with
    negative and +-2^31 edges, several queries in one launch."""
    words = seed_words([0, -1, 2**31 - 1, -(2**31), 987654], "cpu")
    want = sampling.uniform_residues_words_plain(words, shape)
    assert want.shape == (5,) + shape[:-1] + (2, shape[-1])
    np.testing.assert_array_equal(_k10_model(words.numpy(), shape),
                                  want.reshape(-1).numpy())
