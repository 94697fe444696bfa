"""The server's threefry replay against jax.random: the query's `a` halves
must be rebuilt bit for bit from the seed."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spiral_tpu.crypto.query import derive_a_ntt as j_derive
from spiral_tpu_torch.core import threefry
from spiral_tpu_torch.crypto.query import derive_a_ntt

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
