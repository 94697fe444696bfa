"""The port's ring and gadget arithmetic against the JAX package on the
same numpy-seeded inputs: bit equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiral_tpu.core import gadget as jgadget
from spiral_tpu.core import poly as jpoly
from spiral_tpu.core.rescale import rescale_residues_device as j_rescale
from spiral_tpu.params import B_I, P_I
from spiral_tpu_torch.core import gadget, poly
from spiral_tpu_torch.core.rescale import rescale_residues_device

D = 64


def _residues(rng, shape):
    return np.stack([rng.integers(0, P_I, shape), rng.integers(0, B_I, shape)],
                    axis=-2).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("M", [3, 130])
def test_matmul_raw(M):
    rng = np.random.default_rng(M)
    a, b = _residues(rng, (2, 3, M, D)), _residues(rng, (2, M, 2, D))
    _eq(poly.matmul_raw(_t(a), _t(b)), jpoly.matmul_raw(a, b))


def test_add_sub_neg_scalar_mul():
    rng = np.random.default_rng(2)
    a, b = _residues(rng, (4, D)), _residues(rng, (4, D))
    a[0, :, :5] = 0
    _eq(poly.add_raw(_t(a), _t(b)), jpoly.add_raw(a, b))
    _eq(poly.sub_raw(_t(a), _t(b)), jpoly.sub_raw(a, b))
    _eq(poly.neg_raw(_t(a)), jpoly.neg_raw(a))
    _eq(poly.scalar_mul_raw(_t(b[0]), _t(a)), jpoly.scalar_mul_raw(b[0], a))


@pytest.mark.parametrize("t", [D + 1, D // 2 + 1, 5])
def test_automorph_raw(t):
    a = _residues(np.random.default_rng(t), (2, 1, D))
    _eq(poly.automorph_raw(_t(a), t), jpoly.automorph_raw(a, t))


def test_monomial_and_gadget():
    _eq(poly.monomial(-1, D - 4, D, "cpu"),
        jpoly.PolyMat.monomial(-1, D - 4, D).data)
    for rows, cols in ((1, 8), (2, 8), (3, 27), (1, 56)):
        _eq(gadget.build_gadget(rows, cols, D, "cpu"),
            jgadget.build_gadget(rows, cols, D).data)


@pytest.mark.parametrize("m", [4, 8, 56])
def test_gadget_invert_unsigned(m):
    x = _residues(np.random.default_rng(m), (3, 1, 1, D))
    _eq(gadget.gadget_invert_raw(_t(x), m, 1),
        jgadget.gadget_invert_raw(jnp.asarray(x), m, 1))


@pytest.mark.parametrize("t_gsw", [8, 9])
def test_gadget_invert_signed(t_gsw):
    x = _residues(np.random.default_rng(t_gsw), (2, 3, 2, D))
    _eq(gadget.gadget_invert_signed_raw(_t(x), t_gsw, 3),
        jgadget.gadget_invert_signed_raw(jnp.asarray(x), t_gsw, 3))


@pytest.mark.parametrize("out_mod", [1 << 22, 4 * 256, 3604481])
def test_rescale_residues_device(out_mod):
    x = _residues(np.random.default_rng(out_mod % 97), (3, D))
    x[0, :, :3] = [[0, P_I - 1, 1], [0, B_I - 1, 1]]
    want = j_rescale(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]), out_mod)
    _eq(rescale_residues_device(_t(x[:, 0]), _t(x[:, 1]), out_mod), want)
