"""The port's server stages against the JAX package's unfused functions on
the same numpy-seeded inputs (small shapes, nu_2 = 2): bit equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiral_tpu.params import B_I, P_I, Params
from spiral_tpu_torch import params as tparams
from spiral_tpu.server import convert as jconvert
from spiral_tpu.server import expand as jexpand
from spiral_tpu.server import fold as jfold
from spiral_tpu.server.db import EncodedDb as JEncodedDb
from spiral_tpu.server.firstdim import multiply_query_by_db
from spiral_tpu_torch import interop
from spiral_tpu_torch.server import convert, expand, firstdim, fold

D = 64


def _residues(rng, shape):
    return np.stack([rng.integers(0, P_I, shape), rng.integers(0, B_I, shape)],
                    axis=-2).astype(np.uint32)


def _t(a):
    return interop.to_torch(a, "cpu")


def _eq(got, want):
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


def _params(**kw):
    """The same parameters for each package: (JAX Params, port Params)."""
    base = dict(nu_1=2, nu_2=2, p_db=256, t_gsw=8, t_conv=4, t_exp=8,
                t_exp_right=56, poly_len=D)
    base.update(kw)
    return Params(**base), tparams.Params(**base)


def test_firstdim_matches_jax():
    p, tp = _params()
    rng = np.random.default_rng(5)
    K = p.dim0 * p.n0
    data = _residues(rng, (p.num_per, p.n2, K, D))
    qk = _residues(rng, (K, p.n1, D))
    want = multiply_query_by_db(JEncodedDb(jnp.asarray(data), p),
                                jnp.asarray(qk))
    db = interop.encoded_db(data, tp, "cpu")
    res = firstdim.multiply_query_by_db(db.data, _t(qk))
    _eq(firstdim.finish_output(res, p.num_per, p.n2), want)
    np.testing.assert_array_equal(interop.encoded_db_to_jax_layout(db), data)


def test_reorient_query_matches_jax():
    from spiral_tpu.server.firstdim import reorient_query
    cts = _residues(np.random.default_rng(6), (4, 3, 2, D))
    _eq(firstdim.reorient_query(_t(cts)), reorient_query(jnp.asarray(cts)))


@pytest.mark.parametrize("t_gsw", [8, 9])
def test_fold_matches_jax(t_gsw):
    p, tp = _params(t_gsw=t_gsw)
    rng = np.random.default_rng(t_gsw)
    cts = _residues(rng, (p.num_per, p.n1, p.n2, D))
    qp = _residues(rng, (p.nu_2, p.n1, p.m2, D))
    qn = _residues(rng, (p.nu_2, p.n1, p.m2, D))
    want = jfold.fold_rounds(jnp.asarray(cts), jnp.asarray(qp),
                             jnp.asarray(qn), p, fused=False)
    _eq(fold.fold_rounds(_t(cts), _t(qp), _t(qn), tp), want)
    # one round, then the rest from start_round = 1
    half = fold.fold_rounds(_t(cts), _t(qp), _t(qn), tp, 0, 1)
    _eq(fold.fold_ciphertexts(half, _t(qp), _t(qn), tp, start_round=1),
        np.asarray(want)[0])


@pytest.mark.parametrize("stopround", [0, 1])
def test_expansion_matches_jax(stopround):
    p, tp = _params(t_gsw=2)
    g = 3
    max_bits = p.t_gsw * p.further_dims if stopround else 0
    rng = np.random.default_rng(10 + stopround)
    cv0 = _residues(rng, (p.base_dim, 1, D))
    Wl = [_residues(rng, (p.base_dim, p.m_exp, D)) for _ in range(g)]
    Wr = [_residues(rng, (p.base_dim, p.m_exp_right, D)) for _ in range(g)]
    want = jexpand.coefficient_expansion(
        jnp.asarray(cv0), g, [jnp.asarray(w) for w in Wl],
        [jnp.asarray(w) for w in Wr], p, max_bits_to_gen_right=max_bits,
        stopround=stopround, fused=False)
    got = expand.coefficient_expansion(
        _t(cv0), g, [_t(w) for w in Wl], [_t(w) for w in Wr], tp,
        max_bits_to_gen_right=max_bits, stopround=stopround)
    _eq(got, want)
    _eq(expand.reorder_from_stopround(got, 3, 2),
        jexpand.reorder_from_stopround(want, 3, 2))


@pytest.mark.parametrize("d", [256, 2048])
def test_expansion_constants_cached(d):
    """NTT(-x^{d - 2^r}) for every round r, made once per (d, device): the
    plain forward NTT of the monomial, and the same tensors on a second
    call."""
    from spiral_tpu_torch.arith import ntt
    from spiral_tpu_torch.core.poly import monomial
    got = expand.neg_monomial_ntts(d, "cpu")
    assert len(got) == d.bit_length()
    for r, c in enumerate(got):
        assert torch.equal(c, ntt.forward_plain(
            monomial(-1, d - (1 << r), d, "cpu"))[0, 0])
    again = expand.neg_monomial_ntts(d, torch.device("cpu"))
    assert all(a is b for a, b in zip(got, again))


def test_conversion_matches_jax():
    p, tp = _params(t_gsw=3)
    rng = np.random.default_rng(21)
    W = _residues(rng, (p.n1, p.n0 * p.m_conv, D))
    V = _residues(rng, (p.n1, 2 * p.m_conv, D))
    first = _residues(rng, (p.dim0, p.n0, 1, D))
    gsw = _residues(rng, (p.nu_2, p.t_gsw, p.n0, 1, D))
    _eq(convert.scal_to_mat_batch(_t(first), _t(W), tp),
        jconvert.scal_to_mat_batch(jnp.asarray(first), jnp.asarray(W), p))
    _eq(convert.regev_to_gsw_batch(_t(gsw), _t(W), _t(V), tp),
        jconvert.regev_to_gsw_batch(jnp.asarray(gsw), jnp.asarray(W),
                                    jnp.asarray(V), p))


def test_modswitch_matches_jax():
    from spiral_tpu.crypto.decode import modswitch_device as j_modswitch
    from spiral_tpu_torch.crypto.decode import modswitch_device
    p, tp = _params()
    final = _residues(np.random.default_rng(4), (p.n1, p.n2, D))
    for got, want in zip(modswitch_device(_t(final), tp),
                         j_modswitch(jnp.asarray(final), p)):
        _eq(got, want)


def test_wrappers_take_the_plain_path_only_on_cpu():
    from spiral_tpu_torch import kernels
    kernels.reset_launches()
    x = torch.zeros((1, 2, D), dtype=torch.int32)
    expand.keyswitch(torch.zeros((1, 2, 1, 2, D), dtype=torch.int32),
                     torch.zeros((1, 2, 1, 2, D), dtype=torch.int32),
                     torch.zeros((2, 8, 2, D), dtype=torch.int32), 8)
    assert torch.equal(fold.fold_round(torch.zeros((2, 3, 1, 2, D),
                                                   dtype=torch.int32),
                                       torch.zeros((3, 24, 2, D),
                                                   dtype=torch.int32),
                                       torch.zeros((3, 24, 2, D),
                                                   dtype=torch.int32), 8),
                       torch.zeros((1, 3, 1, 2, D), dtype=torch.int32))
    from spiral_tpu_torch.arith import ntt
    assert torch.equal(ntt.forward(x), x)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError):
        kernels.on_cpu(x, x.to("meta"))
