"""SpiralPack: the port's pack functions against the JAX package's unfused
ones on the same numpy-seeded inputs, and both servers on each other's
clients' queries.  All arithmetic is exact: the tolerance is 0."""
import numpy as np
import jax.numpy as jnp
import pytest

from spiral_tpu import pack as jpack
from spiral_tpu.core.poly import PolyMat
from spiral_tpu.crypto.query import Query as JQuery
from spiral_tpu.params import B_I, P_I, Params, preset
from spiral_tpu_torch import interop, pack
from spiral_tpu_torch import params as tparams
from spiral_tpu_torch.server import db as torch_db
from spiral_tpu_torch.server import fold
from spiral_tpu_torch.server import pack as server_pack

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
                t_exp_right=8, poly_len=D, out_n=2)
    base.update(kw)
    return Params(**base), tparams.Params(**base)


def _same_rows(got, want):
    for a, b in zip(interop.response_rows(got), interop.response_rows(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t_gsw", [8, 9])
def test_fold_pack_round_matches_jax(t_gsw):
    p, tp = _params(t_gsw=t_gsw)
    rng = np.random.default_rng(t_gsw)
    cts = _residues(rng, (4, p.num_per, 2, 1, D))
    qp = _residues(rng, (p.nu_2, 2, 2 * t_gsw, D))
    qn = _residues(rng, (p.nu_2, 2, 2 * t_gsw, D))
    want = jpack.fold_pack_rounds(jnp.asarray(cts), jnp.asarray(qp),
                                  jnp.asarray(qn), p, num_rounds=1,
                                  fused=False)
    _eq(fold.fold_pack_round(_t(cts), _t(qn[0]), _t(qp[0]), t_gsw), want)
    # every round, down to the survivors
    _eq(fold.fold_pack_rounds(_t(cts), _t(qp), _t(qn), tp),
        jpack.fold_pack_rounds(jnp.asarray(cts), jnp.asarray(qp),
                               jnp.asarray(qn), p, fused=False))


@pytest.mark.parametrize("out_n", [2, 4, 8])
@pytest.mark.parametrize("m_conv", [4, 56])
def test_pack_ciphertexts_matches_jax(out_n, m_conv):
    p, _ = _params(out_n=out_n, t_conv=m_conv)
    rng = np.random.default_rng(out_n * 100 + m_conv)
    cts = _residues(rng, (out_n * out_n, 2, 1, D))
    v_W = _residues(rng, (out_n, out_n + 1, m_conv, D))
    want = jpack.pack_ciphertexts(jnp.asarray(cts), jnp.asarray(v_W), p,
                                  fused=False)
    _eq(server_pack.pack_ciphertexts(_t(cts), _t(v_W)), want)


def test_regev_to_simple_gsw_matches_jax():
    p, tp = _params(t_gsw=3)
    rng = np.random.default_rng(31)
    cv = _residues(rng, (p.nu_2 * p.t_gsw, 2, 1, D))
    V = _residues(rng, (2, 2 * p.m_conv, D))
    _eq(pack.regev_to_simple_gsw(_t(cv), _t(V), tp),
        jpack.regev_to_simple_gsw(jnp.asarray(cv), jnp.asarray(V), p))


def test_encode_pack_db_matches_jax(monkeypatch):
    p, tp = preset("tiny_pack4"), tparams.preset("tiny_pack4")
    pts = pack.random_pack_db(tp, np.random.default_rng(3))
    # one first-dimension row per block: several blocks
    monkeypatch.setattr(torch_db, "BLOCK_POLYS", p.num_per * p.out_n ** 2)
    db = pack.encode_pack_db(pts, tp, "cpu")
    want = np.asarray(jpack.encode_pack_db(pts, p).data)
    np.testing.assert_array_equal(interop.pack_encoded_db_to_jax_layout(db),
                                  want)
    _eq(interop.pack_encoded_db(want, tp, "cpu").data, interop.to_numpy(
        db.data))


@pytest.mark.parametrize("name", ["tiny_pack", "tiny_pack4"])
def test_torch_pack_server_answers_jax_client(name):
    """The port's PackServer gives the JAX PackServer's response rows for a
    JAX PackClient query, and the JAX client decodes them."""
    p, tp = preset(name), tparams.preset(name)
    client = jpack.PackClient(p, seed=7)
    pub = client.setup()
    pts = pack.random_pack_db(tp, np.random.default_rng(2))
    jdb = jpack.encode_pack_db(pts, p)
    jserver = jpack.PackServer(p, jdb, pub)
    tserver = pack.PackServer(
        tp, interop.pack_encoded_db(np.asarray(jdb.data), tp, "cpu"),
        interop.pack_public_params(
            np.asarray(pub.v_W), [np.asarray(w.data) for w in pub.W_exp_left],
            [np.asarray(w.data) for w in pub.W_exp_right],
            np.asarray(pub.V.data), "cpu"))
    idx = p.total_n - 1
    q = client.query(idx)
    want, _ = jserver.process_query(q)
    got, timings = tserver.process_query(
        interop.query(q.seed, np.asarray(q.packed_b), "cpu"))
    _same_rows(got, want)
    assert np.array_equal(client.decode(got), pts[idx].astype(object))
    assert timings.packing_us > 0 and timings.composition_us == 0
    assert list(tserver.graphs.programs) == [("stages", False, 1)]


def test_jax_pack_server_answers_torch_client():
    """The JAX PackServer answers a port PackClient query at tiny_pack with
    the port server's response rows, and the port client decodes them."""
    p, tp = preset("tiny_pack"), tparams.preset("tiny_pack")
    client = pack.PackClient(tp, seed=5, device="cpu")
    tpub = client.setup()
    pub = interop.pack_public_params_to_numpy(tpub)
    jpub = jpack.PackPublicParams(
        v_W=jnp.asarray(pub["v_W"]),
        W_exp_left=[PolyMat(jnp.asarray(w), True) for w in pub["W_exp_left"]],
        W_exp_right=[PolyMat(jnp.asarray(w), True)
                     for w in pub["W_exp_right"]],
        V=PolyMat(jnp.asarray(pub["V"]), True))
    pts = pack.random_pack_db(tp, np.random.default_rng(4))
    jserver = jpack.PackServer(p, jpack.encode_pack_db(pts, p), jpub)
    idx = 6
    q = client.query(idx)
    fields = interop.query_to_numpy(q)
    want, _ = jserver.process_query(JQuery(
        seed=fields["seed"], packed_b=jnp.asarray(fields["packed_b"])))
    assert np.array_equal(client.decode(want), pts[idx].astype(object))
    tserver = pack.PackServer(tp, pack.encode_pack_db(pts, tp, "cpu"), tpub)
    got, _ = tserver.process_query(q)
    _same_rows(got, want)


@pytest.mark.parametrize("nonoise", [True, False])
def test_run_pack_decodes(nonoise):
    for idx in (0, 15):
        correct, timings, _, _ = pack.run_pack(
            tparams.preset("tiny_pack"), idx=idx, seed=4, nonoise=nonoise,
            device="cpu")
        assert correct and timings.total_us > 0


def test_stream_pack_client_builds_direct_query():
    """At tiny_stream_pack the port's PackClient builds the direct query:
    the JAX client's fields, of its shapes and size_bytes."""
    name = "tiny_stream_pack"
    want = jpack.PackClient(preset(name), seed=2).query(5)
    got = pack.PackClient(tparams.preset(name), device="cpu").query(5)
    assert want.packed_b is None and got.packed_b is None
    assert tuple(got.first_b.shape) == np.asarray(want.first_b).shape
    assert tuple(got.gsw_b.shape) == np.asarray(want.gsw_b).shape
    assert got.size_bytes == want.size_bytes
