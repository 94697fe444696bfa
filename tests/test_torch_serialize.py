"""Wire formats: the port's serialize.py and native.py against the JAX
package's, byte for byte.  Query, response and database-checkpoint bytes
written by the port equal the JAX package's for the same content; public
parameters and checkpoints written by either package load in the other
with equal arrays; a JAX client's query crosses the wire to the port's
server and a port client's to the JAX server, each answer decoding; every
rejection raises the JAX error.  The JAX client and server run once for
the module (tiny).  All arithmetic is exact: the tolerance is 0."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiral_tpu import native as jnative
from spiral_tpu import pack as jpack
from spiral_tpu import pir as jpir
from spiral_tpu import serialize as jser
from spiral_tpu.arith.crt import P_INV_MOD_B
from spiral_tpu.core.poly import PolyMat
from spiral_tpu.crypto.decode import Response as JResponse
from spiral_tpu.crypto.publicparams import PublicParams as JPublicParams
from spiral_tpu.crypto.query import Query as JQuery
from spiral_tpu.params import B_I, P_I, Q, preset
from spiral_tpu.server.db import encode_db as j_encode_db
from spiral_tpu_torch import factored, interop, native, pir, serialize
from spiral_tpu_torch import params as tparams
from spiral_tpu_torch.crypto.decode import Response, modswitch_device
from spiral_tpu_torch.crypto.query import Query
from spiral_tpu_torch.pack import (PackClient, PackPublicParams,
                                   encode_pack_db, random_pack_db)
from spiral_tpu_torch.pir import SpiralClient, SpiralServer
from spiral_tpu_torch.server.db import encode_db, random_db

WIRE_PRESETS = ["tiny", "tiny_pack", "tiny_stream", "tiny_stream_pack",
                "tiny_subround"]
PUB_PRESETS = ["tiny", "tiny_pack", "tiny_stream", "tiny_stream_pack"]


def _is_pack(name):
    return "pack" in name


def _client(name, seed=5):
    cls = PackClient if _is_pack(name) else SpiralClient
    return cls(tparams.preset(name), seed=seed, device="cpu")


def _jax_query(q: Query) -> JQuery:
    f = interop.query_to_numpy(q)
    return JQuery(seed=f["seed"], size_bytes=q.size_bytes, **{
        k: None if f[k] is None else jnp.asarray(f[k])
        for k in ("packed_b", "first_b", "gsw_b")})


def _jax_pub(tpub):
    """A JAX PublicParams / PackPublicParams of the port's arrays."""
    def mats(ws):
        return None if ws is None else [PolyMat(jnp.asarray(w), True)
                                        for w in ws]

    if isinstance(tpub, PackPublicParams):
        f = interop.pack_public_params_to_numpy(tpub)
        return jpack.PackPublicParams(
            v_W=jnp.asarray(f["v_W"]), W_exp_left=mats(f["W_exp_left"]),
            W_exp_right=mats(f["W_exp_right"]),
            V=None if f["V"] is None else PolyMat(jnp.asarray(f["V"]), True))
    f = interop.public_params_to_numpy(tpub)
    return JPublicParams(W_exp_left=mats(f["W_exp_left"]),
                         W_exp_right=mats(f["W_exp_right"]),
                         W_conv=PolyMat(jnp.asarray(f["W_conv"]), True),
                         V=PolyMat(jnp.asarray(f["V"]), True))


def _array(w) -> np.ndarray:
    """A port tensor, a JAX PolyMat or a JAX array -> uint32 numpy."""
    if isinstance(w, torch.Tensor):
        return interop.to_numpy(w)
    return np.asarray(getattr(w, "data", w))


def _pub_arrays(pub) -> dict:
    """Either package's public params -> {field: array or list}."""
    out = {}
    for name in ("W_exp_left", "W_exp_right", "W_conv", "V", "v_W"):
        v = getattr(pub, name, None)
        if v is not None:
            out[name] = [_array(w) for w in v] if isinstance(v, list) \
                else _array(v)
    return out


def _assert_same_pub(a, b):
    a, b = _pub_arrays(a), _pub_arrays(b)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# -- native: bit packing and the Garner lift ---------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.uint64])
@pytest.mark.parametrize("width", [1, 7, 8, 10, 12, 18, 19, 20, 22, 28, 32,
                                   56, 63, 64])
def test_native_matches_jax(width, dtype):
    """bit_pack / bit_unpack equal the JAX package's C++ runtime at counts
    0, 1, g - 1, g and g + 1 (g = 8 / gcd(width, 8) values fill whole
    bytes), 7, 8, 1,000, 4,097 and 2,048*3, from int32 values (as the
    card's rows are fetched) or uint64 ones, at the largest value the
    dtype holds at that width; values with bits set above `width` are
    masked as the C++ masks them; bits past the end of truncated data
    read as 0."""
    assert jnative.available()
    rng = np.random.default_rng(width)
    top = (1 << min(width, 31 if dtype is np.int32 else 64)) - 1
    mask = np.uint64((1 << width) - 1)
    g = 8 // math.gcd(width, 8)
    for n in sorted({0, 1, g - 1, g, g + 1, 7, 8, 1000, 4097, 2048 * 3}):
        v = rng.integers(0, top, size=n, dtype=np.uint64, endpoint=True)
        v[::3] = top
        v = v.astype(dtype)
        blob = native.bit_pack(v, width)
        assert blob == jnative.bit_pack(v, width)
        assert len(blob) == math.ceil(n * width / 8)
        np.testing.assert_array_equal(native.bit_unpack(blob, width, n),
                                      jnative.bit_unpack(blob, width, n))
        np.testing.assert_array_equal(native.bit_unpack(blob, width, n), v)
        # int32: every bit from min(width, 31) up, the sign's extension too
        wide = v | (np.int32(-(1 << min(width, 31))) if dtype is np.int32
                    else ~mask)
        wblob = native.bit_pack(wide, width)
        assert wblob == jnative.bit_pack(wide, width)
        np.testing.assert_array_equal(native.bit_unpack(wblob, width, n),
                                      wide.astype(np.uint64) & mask)
        for cut in (1, 5, 17):
            short = blob[:max(len(blob) - cut, 0)]
            np.testing.assert_array_equal(
                native.bit_unpack(short, width, n),
                jnative.bit_unpack(short.ljust(len(blob), b"\0"), width, n))


def test_crt_lift_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.integers(0, Q, size=5000, dtype=np.uint64)
    v[:4] = [0, Q - 1, P_I - 1, B_I - 1]
    x, y = (v % P_I).astype(np.uint32), (v % B_I).astype(np.uint32)
    got = native.crt_lift_u64(x, y, P_I, B_I, P_INV_MOD_B)
    np.testing.assert_array_equal(got, v)
    np.testing.assert_array_equal(
        got, jnative.crt_lift_u64(x, y, P_I, B_I, P_INV_MOD_B))


# -- query and response bytes -----------------------------------------------

@pytest.mark.parametrize("name", WIRE_PRESETS)
def test_query_bytes_match_jax(name):
    """A port client's query (packed, or direct / subround) serializes to
    the JAX bytes of the same query, and each package parses the other's
    bytes back to the same b rows."""
    tp = tparams.preset(name)
    q = _client(name).query(tp.total_n - 2)
    blob = serialize.query_to_bytes(q, tp)
    assert blob == jser.query_to_bytes(_jax_query(q), preset(name))
    back = serialize.query_from_bytes(blob, tp, "cpu")
    jback = jser.query_from_bytes(blob, preset(name))
    assert back.seed == jback.seed == q.seed
    assert back.size_bytes == jback.size_bytes == len(blob)
    for field in ("packed_b", "first_b", "gsw_b"):
        mine, theirs = getattr(back, field), getattr(jback, field)
        assert (mine is None) == (theirs is None) == \
            (getattr(q, field) is None)
        if mine is not None:
            assert torch.equal(mine, getattr(q, field))
            np.testing.assert_array_equal(interop.to_numpy(mine),
                                          np.asarray(theirs))


@pytest.mark.parametrize("name", WIRE_PRESETS)
def test_response_bytes_match_jax(name):
    """Response rows (n1 x n2 Spiral, out_n + 1 x out_n pack), random
    and at the largest values, serialize to the JAX bytes; each package
    parses the other's."""
    p, tp = preset(name), tparams.preset(name)
    rows, cols = (tp.out_n + 1, tp.out_n) if _is_pack(name) else \
        (tp.n1, tp.n2)
    rng = np.random.default_rng(3)
    first = rng.integers(0, tp.arb_qprime, size=(1, cols, tp.poly_len))
    rest = rng.integers(0, 4 * tp.p_db, size=(rows - 1, cols, tp.poly_len))
    first[0, 0, 0], rest[0, 0, 0] = tp.arb_qprime - 1, 4 * tp.p_db - 1
    resp = Response(first_row=first.astype(object),
                    rest_rows=rest.astype(object))
    blob = serialize.response_to_bytes(resp, tp)
    assert blob == jser.response_to_bytes(
        JResponse(first_row=first.astype(object),
                  rest_rows=rest.astype(object)), p)
    for back in (serialize.response_from_bytes(blob, tp, rows, cols),
                 jser.response_from_bytes(blob, p, rows, cols)):
        np.testing.assert_array_equal(back.first_row, first)
        np.testing.assert_array_equal(back.rest_rows, rest)


def test_wire_sizes_at_full_presets():
    """Byte counts of the full presets' wire: the packed query (one poly)
    at spiral_20_256, the direct one (512 + 30 polys) at
    spiralstream_20_256, and the response at spiral_20_256."""
    def zeros(n):
        return torch.zeros((n, 1, 1, 2, 2048), dtype=torch.int32)

    sp, ss = tparams.preset("spiral_20_256"), \
        tparams.preset("spiralstream_20_256")
    assert len(serialize.query_to_bytes(
        Query(seed=1, packed_b=zeros(1)), sp)) == 14368
    assert len(serialize.query_to_bytes(
        Query(seed=1, first_b=zeros(512), gsw_b=zeros(30)), ss)) == \
        16 + 4 + (8 + 7340032) + (8 + 430080) == 7770148
    resp = Response(first_row=np.zeros((1, sp.n2, 2048), dtype=object),
                    rest_rows=np.zeros((sp.n1 - 1, sp.n2, 2048),
                                       dtype=object))
    assert len(serialize.response_to_bytes(resp, sp)) == 4 + 11264 + 10240
    assert sp.response_size_bytes() == 21504


@pytest.mark.parametrize("path", ["single", "batch", "factored"])
def test_served_responses_are_integer_rows(path):
    """The Responses the served paths build from the device rows (tiny,
    the CPU): one query's (its rows fetched, then server._response, as a
    serving loop calls it), a batch's (process_query_batch, rows equal to
    each query's own) and a factored server's (process_query_fused, F =
    3, rows equal to its final ciphertexts' modulus switch) hold the rows'
    values as uint64 arrays, not object arrays, and write the JAX
    writer's bytes for those rows."""
    p, tp = preset("tiny"), tparams.preset("tiny")
    client = SpiralClient(tp, seed=5, device="cpu")
    rng = np.random.default_rng(4)
    queries = [client.query(i) for i in (3, tp.total_n - 1)]
    if path == "factored":
        pts = rng.integers(0, tp.p_db, size=(tp.total_n, 3, tp.n0, tp.n2,
                                             tp.poly_len))
        server = factored.FactoredSpiralServer(
            tp, factored.encode_factored_db(pts, tp, "cpu"), client.setup())
        want = list(zip(*modswitch_device(
            server.final_ciphertext(queries[0]), tp)))
        got = server.process_query_fused(queries[0])[0]
    else:
        server = SpiralServer(tp, encode_db(random_db(tp, rng), tp, "cpu"),
                              client.setup())
        want = [[x.cpu() for x in pir.serve_single(server, q)]
                for q in queries]
        got = [server._response(*rows) for rows in want] if \
            path == "single" else server.process_query_batch(queries)[0]
    assert len(got) == len(want)
    for resp, (first, rest) in zip(got, want):
        first, rest = first.numpy(), rest.numpy()
        for row, rows in ((resp.first_row, first), (resp.rest_rows, rest)):
            assert row.dtype == np.uint64
            np.testing.assert_array_equal(row, rows)
        assert serialize.response_to_bytes(resp, tp) == \
            jser.response_to_bytes(JResponse(
                first_row=first.astype(object),
                rest_rows=rest.astype(object)), p)


# -- public parameters -------------------------------------------------------

@pytest.mark.parametrize("name", PUB_PRESETS)
def test_public_params_cross_parse(name):
    """The port's SPP1 bytes load in the JAX package and the JAX package's
    in the port with equal arrays, of the variant's type (W_exp_* absent
    where nothing is expanded, V where the stream pack has none); sizes
    are the byte counts.  The npz stamps each entry with the time, so the
    bytes themselves are not compared."""
    p, tp = preset(name), tparams.preset(name)
    tpub = _client(name).setup()
    blob = serialize.public_params_to_bytes(tpub)
    jback = jser.public_params_from_bytes(blob, p)
    _assert_same_pub(jback, tpub)
    assert jback.size_bytes == len(blob)
    jblob = jser.public_params_to_bytes(_jax_pub(tpub))
    back = serialize.public_params_from_bytes(jblob, tp, "cpu")
    assert type(back) is type(tpub) and back.size_bytes == len(jblob)
    _assert_same_pub(back, tpub)


# -- database checkpoints -----------------------------------------------------

@pytest.mark.parametrize("variant", ["spiral", "pack"])
def test_db_checkpoint_cross_load(tmp_path, variant):
    """save_db writes the JAX package's .npy bytes and .json text for the
    same records; each package loads the other's checkpoint with equal
    arrays and params."""
    name = "tiny_pack" if variant == "pack" else "tiny"
    p, tp = preset(name), tparams.preset(name)
    rng = np.random.default_rng(8)
    if variant == "pack":
        pts = random_pack_db(tp, rng)
        jdb, tdb = jpack.encode_pack_db(pts, p), encode_pack_db(pts, tp,
                                                                "cpu")
    else:
        pts = random_db(tp, rng)
        jdb, tdb = j_encode_db(pts, p), encode_db(pts, tp, "cpu")
    jser.save_db(jdb, str(tmp_path / "jax"))
    serialize.save_db(tdb, str(tmp_path / "port"))
    for suffix in (".npy", ".json"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes()
    back = serialize.load_db(str(tmp_path / "jax"), "cpu")
    assert torch.equal(back.data, tdb.data) and back.params == tp
    jback = jser.load_db(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(jback.data),
                                  np.asarray(jdb.data))
    assert dataclasses.asdict(jback.params) == dataclasses.asdict(tp)


# -- rejections ---------------------------------------------------------------

def _same_error(port_call, jax_call):
    with pytest.raises(ValueError) as mine:
        port_call()
    with pytest.raises(ValueError) as theirs:
        jax_call()
    assert str(mine.value) == str(theirs.value)


def test_rejections_match_jax(tmp_path):
    """The retired SPQ1 query, a bad magic, a foreign engine tag on a
    query, public params and a checkpoint, and an untagged checkpoint
    layout raise ValueError with the JAX message."""
    p, tp = preset("tiny"), tparams.preset("tiny")
    q = _client("tiny").query(1)
    good = serialize.query_to_bytes(q, tp)
    pallas = good[:4] + b"pallas".ljust(8) + good[12:]
    for blob in (b"SPQ1" + good[4:], b"XXXX" + good[4:], pallas):
        _same_error(lambda: serialize.query_from_bytes(blob, tp, "cpu"),
                    lambda: jser.query_from_bytes(blob, p))
    pub = serialize.public_params_to_bytes(_client("tiny").setup())
    for blob in (b"XXXX" + pub[4:], pub[:4] + b"pallas".ljust(8) + pub[12:]):
        _same_error(lambda: serialize.public_params_from_bytes(blob, tp,
                                                               "cpu"),
                    lambda: jser.public_params_from_bytes(blob, p))
    path = tmp_path / "db"
    serialize.save_db(encode_db(random_db(tp, np.random.default_rng(0)), tp,
                                "cpu"), str(path))
    meta = (tmp_path / "db.json").read_text()
    for edit in (lambda m: m.pop("__layout__"),
                 lambda m: m.update(__ntt_engine__="pallas")):
        m = serialize.json.loads(meta)
        edit(m)
        (tmp_path / "db.json").write_text(serialize.json.dumps(m))
        _same_error(lambda: serialize.load_db(str(path), "cpu"),
                    lambda: jser.load_db(str(path)))


# -- the wire round trip, both ways -------------------------------------------

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX client (tiny), its public params, a database of records
    encoded by the JAX package and checkpointed, and the JAX server."""
    p = preset("tiny")
    client = jpir.SpiralClient(p, seed=7)
    pub = client.setup()
    pts = random_db(tparams.preset("tiny"), np.random.default_rng(9))
    jdb = j_encode_db(pts, p)
    path = str(tmp_path_factory.mktemp("wire") / "db")
    jser.save_db(jdb, path)
    return dict(p=p, client=client, pub=pub, pts=pts, path=path,
                server=jpir.SpiralServer(p, jdb, pub))


def test_jax_client_to_port_server_over_the_wire(jax_side):
    """A JAX client's query bytes and public-param bytes, and the JAX
    checkpoint, build and feed the port's server; its response bytes are
    the JAX server's and decode with the JAX client."""
    s, tp = jax_side, tparams.preset("tiny")
    idx = tp.total_n - 1
    jq = s["client"].query(idx)
    qblob = jser.query_to_bytes(jq, s["p"])
    pub = serialize.public_params_from_bytes(
        jser.public_params_to_bytes(s["pub"]), tp, "cpu")
    server = SpiralServer(tp, serialize.load_db(s["path"], "cpu"), pub)
    resp, seconds = server.process_query_fused(
        serialize.query_from_bytes(qblob, tp, "cpu"))
    assert seconds > 0
    rblob = serialize.response_to_bytes(resp, tp)
    want, _ = s["server"].process_query(jser.query_from_bytes(qblob,
                                                              s["p"]))
    assert rblob == jser.response_to_bytes(want, s["p"])
    back = jser.response_from_bytes(rblob, s["p"], tp.n1, tp.n2)
    np.testing.assert_array_equal(s["client"].decode(back),
                                  s["pts"][idx].astype(object))


def test_port_client_to_jax_server_over_the_wire(jax_side):
    """A port client (holding the JAX client's keys, so that one JAX
    server answers both) writes the JAX bytes of its query; the JAX server
    answers them and the port client decodes the response bytes."""
    s, tp = jax_side, tparams.preset("tiny")
    keys = s["client"].keys
    client = SpiralClient(tp, seed=11, device="cpu")
    client.keys = interop.secret_keys(
        np.asarray(keys.Sp.data), np.asarray(keys.sr.data),
        keys.Sp_centered, keys.sr_centered, "cpu")
    client.enc.keys = client.keys
    idx = 6
    q = client.query(idx)
    qblob = serialize.query_to_bytes(q, tp)
    assert qblob == jser.query_to_bytes(_jax_query(q), s["p"])
    want, _ = s["server"].process_query(jser.query_from_bytes(qblob,
                                                              s["p"]))
    rblob = jser.response_to_bytes(want, s["p"])
    resp = serialize.response_from_bytes(rblob, tp, tp.n1, tp.n2)
    assert serialize.response_to_bytes(resp, tp) == rblob
    np.testing.assert_array_equal(client.decode(resp),
                                  s["pts"][idx].astype(object))
