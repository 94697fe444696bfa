"""Oversized items: the port's FactoredSpiralServer against the JAX one on
the same JAX client's queries at the tiny preset, F = 3 and F = 13 (the
flattened ct axis, F * num_per = 12 and 52 cts, is no power of two), and
the JAX SpiralServer's final_ciphertext.  The JAX servers run once for
the module.  All arithmetic is exact: the tolerance is 0."""
import collections
import dataclasses
import time

import numpy as np
import pytest
import torch

from spiral_tpu import factored as jfactored
from spiral_tpu import pir as jpir
from spiral_tpu.params import preset
from spiral_tpu_torch import factored, interop, pir
from spiral_tpu_torch import params as tparams
from spiral_tpu_torch.crypto.decode import modswitch_device
from spiral_tpu_torch.server import fold
from spiral_tpu_torch.server.db import encode_db

FACTORS = (3, 13)
IDX = 9


def _pts(p, F):
    rng = np.random.default_rng(20 + F)
    return rng.integers(0, p.p_db, size=(p.total_n, F, p.n0, p.n2,
                                         p.poly_len), dtype=np.int64)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX client, its public params and one query; per F the records,
    the JAX factored server and its process_query and process_query_fused
    responses.  The base server's query stages read no database, so the
    F = 13 server reuses the F = 3 server's, compiled once."""
    p = preset("tiny")
    client = jpir.SpiralClient(p, seed=2)
    pub = client.setup()
    q = client.query(IDX)
    out = {"p": p, "client": client, "pub": pub, "q": q}
    base = None
    for F in FACTORS:
        pts = _pts(p, F)
        jdb = jfactored.encode_factored_db(pts, p)
        server = jfactored.FactoredSpiralServer(p, jdb, pub)
        if base is None:
            base = server._base
        server._base = base
        resps, _ = server.process_query(q)
        fused = server.process_query_fused(q)[0] if F == 3 else None
        out[F] = dict(pts=pts, jdb=jdb, server=server, resps=resps,
                      fused=fused)
    return out


def _torch_server(run, F):
    p, pub = run["p"], run["pub"]
    tp = tparams.preset("tiny")
    db = factored.encode_factored_db(run[F]["pts"], tp, "cpu")
    tpub = interop.public_params(
        [np.asarray(w.data) for w in pub.W_exp_left],
        [np.asarray(w.data) for w in pub.W_exp_right],
        np.asarray(pub.W_conv.data), np.asarray(pub.V.data), "cpu")
    return factored.FactoredSpiralServer(tp, db, tpub), tp


def _tquery(q):
    return interop.query(q.seed, np.asarray(q.packed_b), "cpu")


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(interop.response_rows(g), interop.response_rows(w)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("F", FACTORS)
def test_factored_db_matches_jax_layout(jax_run, F):
    """The port's database is the JAX stacked one, (F, num_per, n2, K, 2,
    d) read as F * num_per cts; the sub-databases given one at a time, as
    a sequence or an iterator, encode to the same tensor."""
    run = jax_run
    tp = tparams.preset("tiny")
    pts = run[F]["pts"]
    p = run["p"]
    want = interop.encoded_db(
        np.asarray(run[F]["jdb"].data).reshape(
            F * p.num_per, p.n2, p.dim0 * p.n0, 2, p.poly_len), tp, "cpu")
    got = factored.encode_factored_db(pts, tp, "cpu")
    assert torch.equal(got.data, want.data)
    subs = [pts[:, f] for f in range(F)]
    assert torch.equal(factored.encode_factored_db(subs, tp, "cpu").data,
                       want.data)
    assert torch.equal(factored.encode_factored_db(
        iter(subs), tp, "cpu", factor=F).data, want.data)
    with pytest.raises(ValueError):
        factored.encode_factored_db(iter(subs), tp, "cpu", factor=F + 1)


@pytest.mark.parametrize("F, path", [(3, "process_query"),
                                     (3, "process_query_fused"),
                                     (13, "process_query"),
                                     (13, "process_query_fused")])
def test_factored_rows_match_jax(jax_run, F, path):
    """Both serving paths give the JAX factored server's rows for the JAX
    client's query (at F = 3 also its fused path's), and every chunk
    decodes to the item's."""
    run = jax_run
    server, tp = _torch_server(run, F)
    got, info = getattr(server, path)(_tquery(run["q"]))
    assert server.factor == F and len(got) == F
    _same(got, run[F]["resps"])
    if run[F]["fused"] is not None:
        _same(got, run[F]["fused"])
    if path == "process_query":
        assert info.first_multiply_us > 0 and info.modswitch_us > 0
        assert list(server.graphs.programs) == [("stages", False, 1)]
    else:
        assert info > 0
        assert list(server.graphs.programs) == [("query_stages", False, 1),
                                                ("tail", False, 1)]
    keys = run["client"].keys
    client = pir.SpiralClient(tp, device="cpu")
    client.keys = interop.secret_keys(
        np.asarray(keys.Sp.data), np.asarray(keys.sr.data),
        keys.Sp_centered, keys.sr_centered, "cpu")
    np.testing.assert_array_equal(factored.decode_factored(client, got),
                                  run[F]["pts"][IDX].astype(object))
    with pytest.raises(ValueError):
        server.process_query_batch([_tquery(run["q"])])


def test_fused_window_excludes_query_stages(monkeypatch):
    """process_query_fused runs expansion, composition and conversion
    before its clock starts and times first dim, fold and modulus switch
    until the rows are on the host, as the JAX server's does
    (spiral_tpu/factored.py:132-147); its rows equal process_query's.  A
    wrapper on each stage and on the clock records their order."""
    tp = tparams.preset("tiny")
    client = pir.SpiralClient(tp, seed=4, device="cpu")
    pts = _pts(tp, 3)
    server = factored.FactoredSpiralServer(
        tp, factored.encode_factored_db(pts, tp, "cpu"), client.setup())
    q = client.query(IDX)
    want, _ = server.process_query(q)
    log = []

    def recorded(tag, fn):
        def run(*args, **kwargs):
            log.append(tag)
            return fn(*args, **kwargs)
        return run

    for name in ("expand_batch", "compose", "convert", "first_dim_batch",
                 "fold"):
        monkeypatch.setattr(server, name, recorded(name, getattr(server,
                                                                 name)))
    monkeypatch.setattr(time, "perf_counter",
                        recorded("clock", time.perf_counter))
    got, seconds = server.process_query_fused(q)
    monkeypatch.undo()
    assert log.count("clock") == 2, log
    start = log.index("clock")
    assert log[:3] == ["expand_batch", "compose", "convert"], log
    window = log[start + 1:log.index("clock", start + 1)]
    assert window == ["first_dim_batch", "fold"], log
    assert seconds > 0
    _same(got, want)
    np.testing.assert_array_equal(factored.decode_factored(client, got),
                                  pts[IDX].astype(object))


@pytest.mark.parametrize("F", FACTORS)
@pytest.mark.parametrize("engine", ["default", "k8b"])
def test_factored_fold_keeps_each_survivor(F, engine, monkeypatch):
    """The fold runs nu_2 rounds over the F * num_per cts, not log2 of
    their count, and its F survivors are each sub-database's own fold,
    with K3 or the K8b round in every round."""
    if engine == "k8b":
        monkeypatch.setattr(fold, "MXU_MIN_COLS", collections.defaultdict(int))
    tp = tparams.preset("tiny")
    g = torch.Generator().manual_seed(F)
    mods = torch.tensor([tparams.P_I, tparams.B_I])[:, None]

    def residues(*shape):
        x = torch.randint(0, 1 << 30, shape + (2, tp.poly_len), generator=g)
        return (x % mods).to(torch.int32)

    cts = residues(F * tp.num_per, tp.n1, tp.n2)
    q_pos, q_neg = (residues(tp.nu_2, tp.n1, tp.m2) for _ in range(2))
    assert (F * tp.num_per).bit_length() - 1 != tp.nu_2
    server = factored.FactoredSpiralServer.__new__(
        factored.FactoredSpiralServer)
    server.params, server._fold_g = tp, None
    got = server.fold(cts, q_pos, q_neg)
    want = torch.stack([fold.fold_ciphertexts(
        cts[f * tp.num_per:(f + 1) * tp.num_per], q_pos, q_neg, tp)
        for f in range(F)])
    assert got.shape == (F, tp.n1, tp.n2, 2, tp.poly_len)
    assert torch.equal(got, want)


def test_final_ciphertext_matches_jax(jax_run):
    """SpiralServer.final_ciphertext (the pre-modswitch survivor,
    coefficient domain) equals the JAX one on sub-database 0 and the
    factored server's first survivor, and its modulus switch gives the
    response rows."""
    run = jax_run
    jq = run["q"]
    want = np.asarray(run[3]["server"]._base.final_ciphertext(jq))
    fserver, tp = _torch_server(run, 3)
    single = pir.SpiralServer(tp, encode_db(run[3]["pts"][:, 0], tp, "cpu"),
                              fserver.pub)
    got = single.final_ciphertext(_tquery(jq))
    np.testing.assert_array_equal(interop.to_numpy(got), want)
    finals = fserver.final_ciphertext(_tquery(jq))
    assert torch.equal(finals[0], got)
    first, rest = modswitch_device(finals, tp)
    _same([pir.Response(first_row=f.numpy(), rest_rows=r.numpy())
           for f, r in zip(first, rest)], run[3]["resps"])


def test_server_timings_splits_match_jax():
    """db_independent_us, db_dependent_us and total_us as the JAX
    ServerTimings defines them."""
    vals = dict(expansion_us=1.5, composition_us=20.25, conversion_us=300.0,
                first_multiply_us=4000.125, folding_us=5e4, packing_us=6.5,
                modswitch_us=7e5)
    t, j = pir.ServerTimings(**vals), jpir.ServerTimings(**vals)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for name in ("db_independent_us", "db_dependent_us", "total_us"):
        assert getattr(t, name) == getattr(j, name)
