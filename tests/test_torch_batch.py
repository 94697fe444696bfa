"""Batch serving: the port's batched first-dim multiply, folds and
expansion against the JAX package's batch functions (or its vmapped
unfused chain, which the JAX batch server runs off the TPU) on the same
numpy-seeded inputs, and the port's batch servers against the JAX servers'
process_query_batch.  All arithmetic is exact: the tolerance is 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spiral_tpu import pack as jpack
from spiral_tpu import pir as jpir
from spiral_tpu.params import B_I, P_I, Params, preset
from spiral_tpu.server import fold as jfold
from spiral_tpu.server.db import encode_db as j_encode_db
from spiral_tpu.server.db import random_implicit_pack_db as j_implicit_pack
from spiral_tpu.server.firstdim import (db_to_mxu_limbs,
                                        finish_mxu_output_batch,
                                        multiply_query_by_db_mxu_batch)
from spiral_tpu_torch import interop, pack, pir
from spiral_tpu_torch import params as tparams
from spiral_tpu_torch.server import db as torch_db
from spiral_tpu_torch.server import expand, firstdim, fold

D = 256


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
                t_exp_right=8, poly_len=D)
    base.update(kw)
    return Params(**base), tparams.Params(**base)


def _same_rows(got, want):
    for a, b in zip(interop.response_rows(got), interop.response_rows(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B", [2, 3])
def test_firstdim_batch_matches_jax(B):
    p, tp = _params()
    rng = np.random.default_rng(40 + B)
    K = p.dim0 * p.n0
    data = _residues(rng, (p.num_per, p.n2, K, D))
    qk = _residues(rng, (B, K, p.n1, D))
    want = finish_mxu_output_batch(
        multiply_query_by_db_mxu_batch(db_to_mxu_limbs(jnp.asarray(data)),
                                       jnp.asarray(qk)), p.num_per, p.n2)
    db = interop.encoded_db(data, tp, "cpu").data
    res = firstdim.multiply_query_by_db_batch(db, _t(qk))
    _eq(firstdim.finish_output_batch(res, p.num_per, p.n2), want)
    # each query's rows are its single multiply's
    for b in range(B):
        _eq(res[:, :, b], firstdim.multiply_query_by_db(db, _t(qk[b])))


@pytest.mark.parametrize("t_gsw", [8, 9])
def test_fold_rounds_batch_matches_jax(t_gsw):
    p, tp = _params(t_gsw=t_gsw)
    rng = np.random.default_rng(50 + t_gsw)
    B = 2
    cts = _residues(rng, (B, p.num_per, p.n1, p.n2, D))
    qp = _residues(rng, (B, p.nu_2, p.n1, p.m2, D))
    qn = _residues(rng, (B, p.nu_2, p.n1, p.m2, D))
    want = jax.vmap(lambda c, a, b: jfold.fold_rounds(c, a, b, p,
                                                      fused=False))(
        jnp.asarray(cts), jnp.asarray(qp), jnp.asarray(qn))
    _eq(fold.fold_rounds_batch(_t(cts), _t(qp), _t(qn), tp), want)
    # one K5 round is each query's own round
    one = fold.fold_round_batch(_t(cts), _t(qn[:, 0]), _t(qp[:, 0]), t_gsw)
    for b in range(B):
        _eq(one[b], fold.fold_round(_t(cts[b]), _t(qn[b, 0]), _t(qp[b, 0]),
                                    t_gsw))


@pytest.mark.parametrize("t_gsw", [8, 9])
def test_fold_pack_rounds_batch_matches_jax(t_gsw):
    p, tp = _params(t_gsw=t_gsw, out_n=2)
    rng = np.random.default_rng(60 + t_gsw)
    B, T = 2, p.out_n ** 2
    cts = _residues(rng, (B, T, p.num_per, 2, 1, D))
    qp = _residues(rng, (B, p.nu_2, 2, 2 * t_gsw, D))
    qn = _residues(rng, (B, p.nu_2, 2, 2 * t_gsw, D))
    want = jax.vmap(lambda c, a, b: jpack.fold_pack_rounds(c, a, b, p,
                                                           fused=False))(
        jnp.asarray(cts), jnp.asarray(qp), jnp.asarray(qn))
    _eq(fold.fold_pack_rounds_batch(_t(cts), _t(qp), _t(qn), tp), want)


@pytest.mark.parametrize("stopround", [0, 1])
def test_expansion_batch_equals_single_calls(stopround):
    _, tp = _params(t_gsw=2)
    g, B = 3, 3
    max_bits = tp.t_gsw * tp.further_dims if stopround else 0
    rng = np.random.default_rng(70 + stopround)
    cv0 = _t(_residues(rng, (B, 2, 1, D)))
    Wl = [_t(_residues(rng, (2, tp.m_exp, D))) for _ in range(g)]
    Wr = [_t(_residues(rng, (2, tp.m_exp_right, D))) for _ in range(g)]
    got = expand.coefficient_expansion(cv0, g, Wl, Wr, tp,
                                       max_bits_to_gen_right=max_bits,
                                       stopround=stopround)
    assert got.shape == (B, 1 << g, 2, 1, 2, D)
    for b in range(B):
        _eq(got[b], interop.to_numpy(expand.coefficient_expansion(
            cv0[b], g, Wl, Wr, tp, max_bits_to_gen_right=max_bits,
            stopround=stopround)))


def _jax_batch(client, jserver, tserver, idxs):
    """The JAX client's queries for idxs, answered by the JAX server's
    process_query_batch and by the port's, and by the port one at a time."""
    qs = [client.query(i) for i in idxs]
    want, _ = jserver.process_query_batch(qs)
    tqs = [interop.query(q.seed, np.asarray(q.packed_b), "cpu") for q in qs]
    got, seconds = tserver.process_query_batch(tqs)
    assert seconds > 0 and len(got) == len(idxs)
    assert tserver.last_timings.total_us > 0
    singles = [tserver.process_query(q)[0] for q in tqs]
    return want, got, singles


def test_torch_batch_server_answers_jax_client():
    """At tiny: the port's SpiralServer answers a batch of JAX SpiralClient
    queries with JAX process_query_batch's rows, each equal to the port's
    single-query rows and decoding to its record."""
    p, tp = preset("tiny"), tparams.preset("tiny")
    client = jpir.SpiralClient(p, seed=11)
    pub = client.setup()
    pts = torch_db.random_db(tp, np.random.default_rng(12))
    jdb = j_encode_db(pts, p)
    jserver = jpir.SpiralServer(p, jdb, pub)
    tserver = pir.SpiralServer(
        tp, interop.encoded_db(np.asarray(jdb.data), tp, "cpu"),
        interop.public_params([np.asarray(w.data) for w in pub.W_exp_left],
                              [np.asarray(w.data) for w in pub.W_exp_right],
                              np.asarray(pub.W_conv.data),
                              np.asarray(pub.V.data), "cpu"))
    idxs = [0, p.total_n - 1, 6]
    want, got, singles = _jax_batch(client, jserver, tserver, idxs)
    for i, w, g, s in zip(idxs, want, got, singles):
        _same_rows(g, w)
        _same_rows(s, g)
        assert np.array_equal(client.decode(g), pts[i].astype(object))


def _pack_servers(name, seed):
    p, tp = preset(name), tparams.preset(name)
    client = jpack.PackClient(p, seed=seed)
    pub = client.setup()
    tpub = interop.pack_public_params(
        np.asarray(pub.v_W), [np.asarray(w.data) for w in pub.W_exp_left],
        [np.asarray(w.data) for w in pub.W_exp_right],
        np.asarray(pub.V.data), "cpu")
    return p, tp, client, pub, tpub


def test_torch_pack_batch_server_answers_jax_client():
    """The same for SpiralPack at tiny_pack."""
    p, tp, client, pub, tpub = _pack_servers("tiny_pack", 13)
    pts = pack.random_pack_db(tp, np.random.default_rng(14))
    jdb = jpack.encode_pack_db(pts, p)
    jserver = jpack.PackServer(p, jdb, pub)
    tserver = pack.PackServer(
        tp, interop.pack_encoded_db(np.asarray(jdb.data), tp, "cpu"), tpub)
    idxs = [0, p.total_n - 1, 9]
    want, got, singles = _jax_batch(client, jserver, tserver, idxs)
    for i, w, g, s in zip(idxs, want, got, singles):
        _same_rows(g, w)
        _same_rows(s, g)
        assert np.array_equal(client.decode(g), pts[i].astype(object))


def test_pack_batch_over_implicit_db_raises():
    """As the JAX PackServer does (pack.py:583-585); its single queries
    still run."""
    p, tp, client, pub, tpub = _pack_servers("tiny_pack", 15)
    jserver = jpack.PackServer(p, j_implicit_pack(
        p, np.random.default_rng(16), max_slab_bytes=1 << 15), pub)
    tserver = pack.PackServer(tp, torch_db.random_implicit_pack_db(
        tp, np.random.default_rng(16), max_slab_bytes=1 << 15, device="cpu"),
        tpub)
    assert tserver.num_chunks > 1
    q = client.query(3)
    with pytest.raises(ValueError):
        jserver.process_query_batch([q])
    with pytest.raises(ValueError):
        tserver.process_query_batch(
            [interop.query(q.seed, np.asarray(q.packed_b), "cpu")])
