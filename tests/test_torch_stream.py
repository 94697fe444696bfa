"""SpiralStream: the port's direct-upload query, reconstruction and server
against the JAX package's on the same inputs, and each package's server
on the other's client's queries, at the tiny stream presets (tiny_stream:
both parts uploaded directly; tiny_subround: both parts as subround cts
the server expands).  The JAX servers run once per preset for the module.
All arithmetic is exact: the tolerance is 0."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiral_tpu import pir as jpir
from spiral_tpu.core.poly import PolyMat
from spiral_tpu.crypto import query as jquery
from spiral_tpu.crypto.publicparams import PublicParams as JPublicParams
from spiral_tpu.params import preset
from spiral_tpu.server.db import encode_db as j_encode_db
from spiral_tpu_torch import interop, pir
from spiral_tpu_torch import params as tparams
from spiral_tpu_torch.crypto import query as tquery
from spiral_tpu_torch.crypto.publicparams import expansion_rounds
from spiral_tpu_torch.server import db as torch_db

TINY = ["tiny_stream", "tiny_subround"]
STREAM = TINY + ["spiralstream_20_256", "spiralstream_20_256_paper"]


def _same_rows(got, want):
    for a, b in zip(interop.response_rows(got), interop.response_rows(want)):
        np.testing.assert_array_equal(a, b)


def _tquery(q):
    """A JAX stream client's query, for the port's server."""
    return interop.query(q.seed, None, "cpu", first_b=np.asarray(q.first_b),
                         gsw_b=np.asarray(q.gsw_b))


def _torch_pub(pub):
    return interop.public_params(
        None if pub.W_exp_left is None else
        [np.asarray(w.data) for w in pub.W_exp_left],
        None if pub.W_exp_right is None else
        [np.asarray(w.data) for w in pub.W_exp_right],
        np.asarray(pub.W_conv.data), np.asarray(pub.V.data), "cpu")


def _jax_pub(tpub):
    f = interop.public_params_to_numpy(tpub)
    mats = {k: None if f[k] is None else
            [PolyMat(jnp.asarray(w), True) for w in f[k]]
            for k in ("W_exp_left", "W_exp_right")}
    return JPublicParams(W_conv=PolyMat(jnp.asarray(f["W_conv"]), True),
                         V=PolyMat(jnp.asarray(f["V"]), True), **mats)


@pytest.fixture(scope="module")
def jax_run():
    """name -> a dict of both packages' params, the JAX client, its public
    params and server, the records, the port's server on the JAX
    database and keys, and the JAX client's query for total_n - 1 with
    the JAX server's response; each made once for the module."""
    runs = {}

    def get(name):
        if name not in runs:
            p, tp = preset(name), tparams.preset(name)
            client = jpir.SpiralClient(p, seed=7)
            pub = client.setup()
            pts = torch_db.random_db(tp, np.random.default_rng(2))
            jdb = j_encode_db(pts, p)
            jserver = jpir.SpiralServer(p, jdb, pub)
            tserver = pir.SpiralServer(
                tp, interop.encoded_db(np.asarray(jdb.data), tp, "cpu"),
                _torch_pub(pub))
            idx = p.total_n - 1
            q = client.query(idx)
            want, _ = jserver.process_query(q)
            runs[name] = dict(p=p, tp=tp, client=client, pub=pub, pts=pts,
                              jdb=jdb, jserver=jserver, tserver=tserver,
                              idx=idx, q=q, want=want)
        return runs[name]

    return get


@pytest.mark.parametrize("name", STREAM)
def test_subround_sigmas_match_jax(name):
    """The upload's plaintexts equal JAX subround_sigma_polys' as exact
    integers, at the tiny presets and at full size (host only)."""
    p, tp = preset(name), tparams.preset(name)
    for idx in (0, p.total_n - 1, 4 * p.num_per + 3):
        want = jquery.subround_sigma_polys(p, idx)
        got = tquery.subround_sigma_polys(tp, idx)
        assert got.shape == want.shape
        assert (got == want).all()


@pytest.mark.parametrize("name", TINY)
def test_reconstruct_direct_matches_jax(jax_run, name):
    """The port's reconstruction (and each subround part's expansion)
    equals the JAX server's _stage_reconstruct on the same seed and b
    rows."""
    r = jax_run(name)
    q = r["q"]
    want = r["jserver"]._stage_reconstruct(jnp.int32(q.seed), q.first_b,
                                            q.gsw_b)
    tq = _tquery(q)
    got = r["tserver"].reconstruct_direct_batch(
        [tq.seed], tquery.query_b_rows(tq)[None])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g[0]), np.asarray(w))


@pytest.mark.parametrize("name", TINY)
def test_torch_server_answers_jax_stream_client(jax_run, name):
    """The port's server gives the JAX server's response rows for a JAX
    stream client's query, and the JAX client decodes them."""
    r = jax_run(name)
    got, timings = r["tserver"].process_query(_tquery(r["q"]))
    _same_rows(got, r["want"])
    assert np.array_equal(r["client"].decode(got),
                          r["pts"][r["idx"]].astype(object))
    assert timings.expansion_us > 0
    assert ("stages", True, 1) in r["tserver"].graphs.programs


@pytest.mark.parametrize("name", TINY)
def test_jax_server_answers_torch_stream_client(jax_run, name):
    """The JAX server, given the port client's public params, answers the
    port client's stream query; the port client decodes the answer, and
    the port's server gives the same rows."""
    r = jax_run(name)
    p, tp, pts = r["p"], r["tp"], r["pts"]
    client = pir.SpiralClient(tp, seed=5, device="cpu")
    tpub = client.setup()
    idx = 5
    q = client.query(idx)
    assert q.packed_b is None and q.size_bytes == p.query_size_bytes()
    jserver = jpir.SpiralServer(p, r["jdb"], _jax_pub(tpub))
    f = interop.query_to_numpy(q)
    want, _ = jserver.process_query(jquery.Query(
        seed=f["seed"], first_b=jnp.asarray(f["first_b"]),
        gsw_b=jnp.asarray(f["gsw_b"])))
    assert np.array_equal(client.decode(want), pts[idx].astype(object))
    tserver = pir.SpiralServer(tp, torch_db.encode_db(pts, tp, "cpu"), tpub)
    _same_rows(tserver.process_query(q)[0], want)


def test_torch_stream_batch_matches_jax(jax_run):
    """At tiny_stream the port's process_query_batch of direct queries
    gives JAX process_query_batch's rows, each equal to the port's
    single-query rows and decoding to its record; a batch that mixes the
    packed and the direct form raises ValueError."""
    r = jax_run("tiny_stream")
    idxs = [0, r["p"].total_n - 1, 6]
    qs = [r["client"].query(i) for i in idxs]
    want, _ = r["jserver"].process_query_batch(qs)
    tqs = [_tquery(q) for q in qs]
    got, seconds = r["tserver"].process_query_batch(tqs)
    assert seconds > 0 and r["tserver"].last_timings.expansion_us > 0
    for i, q, w, g in zip(idxs, tqs, want, got):
        _same_rows(g, w)
        _same_rows(r["tserver"].process_query(q)[0], g)
        assert np.array_equal(r["client"].decode(g),
                              r["pts"][i].astype(object))
    packed = tquery.Query(seed=1, packed_b=torch.zeros(
        (1, 1, 1, 2, r["p"].poly_len), dtype=torch.int32))
    with pytest.raises(ValueError):
        r["tserver"].process_query_batch([tqs[0], packed])


@pytest.mark.parametrize("name", TINY)
def test_stream_public_params_match_jax(jax_run, name):
    """W_exp_left/right are None exactly where JAX's are (both parts
    direct), else lists of the same shapes; V is made either way."""
    r = jax_run(name)
    pub = r["pub"]
    tpub = pir.SpiralClient(r["tp"], seed=3, device="cpu").setup()
    for w, tw in ((pub.W_exp_left, tpub.W_exp_left),
                  (pub.W_exp_right, tpub.W_exp_right)):
        assert (w is None) == (tw is None)
        if w is not None:
            assert [tuple(np.asarray(x.data).shape) for x in w] == \
                [tuple(x.shape) for x in tw]
    assert tuple(tpub.V.shape) == np.asarray(pub.V.data).shape
    assert (pub.W_exp_left is None) == (name == "tiny_stream")


@pytest.mark.parametrize("name", STREAM)
def test_stream_preset_builds(name):
    """Each SpiralStream preset builds a client, public params with the
    expansion keys its plan asks for, a query of the preset's upload size
    and a server (on a one-row implicit slab: a full-size database does
    not fit this test), on the CPU."""
    tp = tparams.preset(name)
    client = pir.SpiralClient(tp, seed=1, device="cpu")
    pub = client.setup()
    g, right = expansion_rounds(tp)
    assert (pub.W_exp_left is None) == (g == 0)
    if g:
        assert len(pub.W_exp_left) == g and len(pub.W_exp_right) == right
    q = client.query(tp.total_n - 1)
    plan = tp.expansion_plan()
    assert q.first_b.shape[0] == plan["first"]["n_cts"]
    assert q.gsw_b.shape[0] == plan["rest"]["n_cts"]
    assert q.size_bytes == tp.query_size_bytes()
    db = torch_db.random_implicit_db(tp, np.random.default_rng(1),
                                     max_slab_bytes=1, device="cpu")
    assert db.slab_per == 1
    pir.SpiralServer(tp, db, pub)
