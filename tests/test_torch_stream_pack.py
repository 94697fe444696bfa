"""SpiralStreamPack: the port's direct-upload pack query, reconstruction,
direct conversion and server against the JAX package's on the same
inputs, and each package's server on the other's client's queries, at the
tiny stream-pack presets (tiny_stream_pack_bigp: p = 65,536 and q' = 2^28,
the full-size preset's moduli).  The JAX servers run once per preset for
the module.  All arithmetic is exact: the tolerance is 0."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiral_tpu import pack as jpack
from spiral_tpu.core.poly import scalar_mul_raw, sub_raw
from spiral_tpu.crypto import query as jquery
from spiral_tpu.params import preset
from spiral_tpu_torch import interop, pack
from spiral_tpu_torch import params as tparams
from spiral_tpu_torch.crypto.query import Query, query_b_rows
from spiral_tpu_torch.server import db as torch_db

TINY = ["tiny_stream_pack", "tiny_stream_pack_bigp"]
STREAM_PACK = TINY + ["tiny_stream_pack_paper", "spiralstreampack_20_256",
                      "spiralstreampack_20_256_paper"]


def _same_rows(got, want):
    for a, b in zip(interop.response_rows(got), interop.response_rows(want)):
        np.testing.assert_array_equal(a, b)


def _tquery(q):
    """A JAX stream-pack client's query, for the port's server."""
    return interop.query(q.seed, None, "cpu", first_b=np.asarray(q.first_b),
                         gsw_b=np.asarray(q.gsw_b))


@pytest.fixture(scope="module")
def jax_run():
    """name -> a dict of both packages' params, the JAX client, its public
    params and server, the records, the port's server on the JAX database
    and keys, and the JAX client's query for total_n - 1 with the JAX
    server's response; each made once for the module."""
    runs = {}

    def get(name):
        if name not in runs:
            p, tp = preset(name), tparams.preset(name)
            client = jpack.PackClient(p, seed=7)
            pub = client.setup()
            pts = pack.random_pack_db(tp, np.random.default_rng(2))
            jdb = jpack.encode_pack_db(pts, p)
            jserver = jpack.PackServer(p, jdb, pub)
            tserver = pack.PackServer(
                tp, interop.pack_encoded_db(np.asarray(jdb.data), tp, "cpu"),
                interop.pack_public_params(np.asarray(pub.v_W), None, None,
                                           None, "cpu"))
            idx = p.total_n - 1
            q = client.query(idx)
            want, _ = jserver.process_query(q)
            runs[name] = dict(p=p, tp=tp, client=client, pub=pub, pts=pts,
                              jdb=jdb, jserver=jserver, tserver=tserver,
                              idx=idx, q=q, want=want)
        return runs[name]

    return get


@pytest.mark.parametrize("name", ["tiny_stream_pack",
                                  "spiralstreampack_20_256"])
def test_stream_pack_sigmas_match_jax(name):
    """The query's plaintexts equal those of the JAX client, as exact
    residues: the JAX client encrypts with its noise switched off, so b -
    a*sr is its plaintext."""
    p, tp = preset(name), tparams.preset(name)
    client = jpack.PackClient(p, seed=3)
    client.enc.nonoise = True
    sr_ntt = client.keys.sr.to_ntt().data[0, 0]
    for idx in (0, p.total_n - 1, 2 * p.num_per + 5):
        q = client.query(idx)
        b = jnp.concatenate([q.first_b, q.gsw_b])
        want = sub_raw(b, scalar_mul_raw(sr_ntt, jquery.derive_a_ntt(
            q.seed, b.shape[0], p.poly_len)))
        got = pack.stream_pack_sigmas(
            tp, idx, interop.to_torch(np.asarray(sr_ntt), "cpu"))
        np.testing.assert_array_equal(interop.to_numpy(got),
                                      np.asarray(want))


def test_reconstruct_and_conv_direct_match_jax(jax_run):
    """The port's reconstruction and direct conversion equal the JAX
    server's _stage_reconstruct and _stage_conv_direct on the same seed
    and b rows."""
    r = jax_run("tiny_stream_pack")
    q = r["q"]
    first, gsw = r["jserver"]._stage_reconstruct(jnp.int32(q.seed),
                                                 q.first_b, q.gsw_b)
    want = (first, gsw) + tuple(r["jserver"]._stage_conv_direct(gsw))
    tq = _tquery(q)
    t_first, t_gsw = r["tserver"].reconstruct_direct_batch(
        [tq.seed], query_b_rows(tq)[None])
    got = (t_first[0], t_gsw[0]) + r["tserver"].conv_direct(t_gsw[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("name", TINY)
def test_torch_pack_server_answers_jax_stream_client(jax_run, name):
    """The port's PackServer gives the JAX PackServer's response rows for
    a JAX stream-pack client's query, and the JAX client decodes them."""
    r = jax_run(name)
    got, timings = r["tserver"].process_query(_tquery(r["q"]))
    _same_rows(got, r["want"])
    assert np.array_equal(r["client"].decode(got),
                          r["pts"][r["idx"]].astype(object))
    assert timings.expansion_us > 0 and timings.packing_us > 0


@pytest.mark.parametrize("name", TINY)
def test_jax_pack_server_answers_torch_stream_client(jax_run, name):
    """The JAX PackServer, given the port client's packing keys, answers
    the port client's stream-pack query; the port client decodes the
    answer, and the port's server gives the same rows."""
    r = jax_run(name)
    p, tp, pts = r["p"], r["tp"], r["pts"]
    client = pack.PackClient(tp, seed=5, device="cpu")
    tpub = client.setup()
    f = interop.pack_public_params_to_numpy(tpub)
    assert f["W_exp_left"] is f["W_exp_right"] is f["V"] is None
    jserver = jpack.PackServer(p, r["jdb"], jpack.PackPublicParams(
        v_W=jnp.asarray(f["v_W"]), W_exp_left=None, W_exp_right=None,
        V=None))
    idx = 6
    q = client.query(idx)
    fq = interop.query_to_numpy(q)
    want, _ = jserver.process_query(jquery.Query(
        seed=fq["seed"], first_b=jnp.asarray(fq["first_b"]),
        gsw_b=jnp.asarray(fq["gsw_b"])))
    assert np.array_equal(client.decode(want), pts[idx].astype(object))
    tserver = pack.PackServer(tp, pack.encode_pack_db(pts, tp, "cpu"), tpub)
    _same_rows(tserver.process_query(q)[0], want)


def test_torch_stream_pack_batch_matches_jax(jax_run):
    """At tiny_stream_pack the port's process_query_batch of direct
    queries gives JAX process_query_batch's rows, each equal to the port's
    single-query rows and decoding to its record; a batch that mixes the
    packed and the direct form raises ValueError."""
    r = jax_run("tiny_stream_pack")
    idxs = [0, r["p"].total_n - 1, 9]
    qs = [r["client"].query(i) for i in idxs]
    want, _ = r["jserver"].process_query_batch(qs)
    tqs = [_tquery(q) for q in qs]
    got, seconds = r["tserver"].process_query_batch(tqs)
    assert seconds > 0 and r["tserver"].last_timings.packing_us > 0
    for i, q, w, g in zip(idxs, tqs, want, got):
        _same_rows(g, w)
        _same_rows(r["tserver"].process_query(q)[0], g)
        assert np.array_equal(r["client"].decode(g),
                              r["pts"][i].astype(object))
    packed = Query(seed=1, packed_b=torch.zeros(
        (1, 1, 1, 2, r["p"].poly_len), dtype=torch.int32))
    with pytest.raises(ValueError):
        r["tserver"].process_query_batch([packed, tqs[0]])


@pytest.mark.parametrize("name", TINY)
def test_stream_pack_public_params_match_jax(jax_run, name):
    """With direct_upload_first only the packing keys are made: W_exp_*
    and V are None in both packages, and v_W has JAX's shape."""
    r = jax_run(name)
    pub = r["pub"]
    tpub = pack.PackClient(r["tp"], seed=3, device="cpu").setup()
    assert pub.W_exp_left is pub.W_exp_right is pub.V is None
    assert tpub.W_exp_left is tpub.W_exp_right is tpub.V is None
    assert tuple(tpub.v_W.shape) == np.asarray(pub.v_W).shape


@pytest.mark.parametrize("name", STREAM_PACK)
def test_stream_pack_preset_builds(name):
    """Each SpiralStreamPack preset builds a client, its packing keys, a
    direct query of dim0 + 2*nu_2*t_gsw cts and a server (on a one-row
    implicit slab), on the CPU."""
    tp = tparams.preset(name)
    assert tp.direct_upload_first
    client = pack.PackClient(tp, seed=1, device="cpu")
    pub = client.setup()
    assert pub.W_exp_left is pub.W_exp_right is pub.V is None
    assert tuple(pub.v_W.shape) == (tp.out_n, tp.out_n + 1, tp.m_conv, 2,
                                    tp.poly_len)
    q = client.query(tp.total_n - 1)
    n_gsw = 2 * tp.further_dims * tp.t_gsw
    assert (q.first_b.shape[0], q.gsw_b.shape[0]) == (tp.dim0, n_gsw)
    assert q.size_bytes == (tp.dim0 + n_gsw) * tp.bytes_per_poly
    db = torch_db.random_implicit_pack_db(tp, np.random.default_rng(1),
                                          max_slab_bytes=1, device="cpu")
    assert db.slab_per == 1
    pack.PackServer(tp, db, pub)
