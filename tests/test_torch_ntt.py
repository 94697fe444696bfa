"""The port's plain NTT against the JAX mxu engine: bit equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiral_tpu.arith.ntt_mxu import CrtNttMxu
from spiral_tpu.params import B_I, P_I
from spiral_tpu_torch.arith import ntt
from spiral_tpu_torch.arith.tables import ntt_tables


def _residues(rng, shape):
    return np.stack([rng.integers(0, P_I, shape), rng.integers(0, B_I, shape)],
                    axis=-2).astype(np.uint32)


@pytest.mark.parametrize("d", [256, 2048])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_ntt_matches_jax_mxu(d, direction):
    x = _residues(np.random.default_rng(d), (3, d))
    want = np.asarray(getattr(CrtNttMxu(d), direction)(jnp.asarray(x)))
    got = getattr(ntt, direction)(torch.from_numpy(x.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_ntt_round_trip_and_tables():
    d = 64
    tb = ntt_tables(d)
    np.testing.assert_array_equal(tb.pos_of_slot[tb.slot_of_pos], np.arange(d))
    x = torch.from_numpy(_residues(np.random.default_rng(1), (2, 5, d))
                         .astype(np.int32))
    assert torch.equal(ntt.inverse(ntt.forward(x)), x)
