"""The port's served path (spiral_tpu_torch/graphs.py's staged runner) on a
CPU server at the tiny presets, where it runs its body eagerly on the
staged inputs and clones its static outputs as a CUDA-graph replay does:
distinct queries enqueued back to back and fetched only at the end each
get their own rows (no stale input, no aliased output), equal to the
eager stages' rows and, at tiny, to one JAX SpiralServer's one-dispatch
_run_single; batches served twice and two batch sizes in one server; the
factored server's served tail.  All arithmetic is exact: the tolerance is
0.  The capture itself runs only on the card (chip_smoke.py).  Torch runs
one intra-op thread in this module (restored after it): the tiny
presets' ops gain nothing from more, and the suite's parallel workers
share the cores."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiral_tpu import pir as jpir
from spiral_tpu.core.poly import PolyMat
from spiral_tpu.crypto.publicparams import PublicParams as JPublicParams
from spiral_tpu.crypto.query import Query as JQuery
from spiral_tpu.params import preset as jpreset
from spiral_tpu.server.db import encode_db as j_encode_db
from spiral_tpu_torch import factored, graphs, interop, kernels, tracing
from spiral_tpu_torch.pack import (PackClient, PackServer, encode_pack_db,
                                   random_pack_db)
from spiral_tpu_torch.crypto.query import seed_words
from spiral_tpu_torch.params import preset
from spiral_tpu_torch.pir import SPIRAL_STAGES, SpiralClient, SpiralServer
from spiral_tpu_torch.server.db import encode_db, random_db

PRESETS = ("tiny", "tiny_pack", "tiny_stream", "tiny_stream_pack")
IDXS = (0, 5, 9, 15)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _serve(name: str):
    """(client, server, records) at `name`, on the CPU."""
    p = preset(name)
    pack = "pack" in name
    client = (PackClient if pack else SpiralClient)(p, seed=6, device="cpu")
    pts = (random_pack_db if pack else random_db)(p,
                                                  np.random.default_rng(7))
    encode = encode_pack_db if pack else encode_db
    server = (PackServer if pack else SpiralServer)(
        p, encode(pts, p, CPU), client.setup())
    return client, server, pts


def _equal_rows(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", PRESETS)
def test_pipelined_queries_get_their_own_rows(name):
    """Four distinct queries through _run_single, every response fetched
    only after the last is enqueued: each equals its query's eager rows
    and decodes to its record; the runner holds one program, whose static
    outputs no response aliases."""
    client, server, pts = _serve(name)
    queries = [client.query(i) for i in IDXS]
    direct = queries[0].packed_b is None
    assert direct == ("stream" in name)
    outs = [server._run_single(q) for q in queries]
    for i, q, rows in zip(IDXS, queries, outs):
        assert _equal_rows(rows, server._run_eager(q)), i
        np.testing.assert_array_equal(
            client.decode(server._response(*rows)), pts[i].astype(object))
    assert not torch.equal(outs[0][1], outs[1][1])
    prog = server.graphs.programs[("single", direct, 1)]
    assert list(server.graphs.programs) == [("single", direct, 1)]
    assert prog.graphs == [] and server.serving == "eager"
    static = {t.data_ptr() for t in prog.outputs}
    assert not static & {t.data_ptr() for rows in outs for t in rows}
    # the staged inputs hold the last query's b rows
    want = queries[-1].packed_b if not direct else torch.cat(
        [queries[-1].first_b, queries[-1].gsw_b])
    assert torch.equal(prog.inputs[1][0], want)


@pytest.mark.parametrize("name", PRESETS)
def test_stage_chain_serves_each_query_its_own(name):
    """Two different queries in turn through process_query (the stage
    chain, key ("stages", form, 1)), interleaved with _run_single on the
    same server: each response equals its query's eager rows and decodes,
    the chain's staged inputs after the second call are that call's own,
    and the timings hold the path's stages (pack: packing, no
    composition)."""
    client, server, pts = _serve(name)
    queries = [client.query(i) for i in IDXS[1:3]]
    direct = queries[0].packed_b is None
    for i, q in zip(IDXS[1:3], queries):
        resp, timings = server.process_query(q)
        eager = server._run_eager(q)
        for got, want in zip(interop.response_rows(resp), eager):
            np.testing.assert_array_equal(
                got, interop.to_numpy(want).astype(object))
        np.testing.assert_array_equal(client.decode(resp),
                                      pts[i].astype(object))
        assert _equal_rows(server._run_single(q), eager)
        pack = "pack" in name
        assert (timings.packing_us > 0) == pack
        assert (timings.composition_us > 0) != pack
        assert timings.total_us > 0
    prog = server.graphs.programs[("stages", direct, 1)]
    last = queries[-1]
    want = last.packed_b if not direct else torch.cat([last.first_b,
                                                       last.gsw_b])
    assert torch.equal(prog.inputs[1][0], want)
    assert torch.equal(prog.inputs[0], seed_words([last.seed], "cpu"))
    assert prog.graphs == []


class _FakeGraph:
    """torch.cuda.CUDAGraph's capture and replay calls, logged."""
    log: list = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.log.append(("begin", pool, capture_error_mode))

    def capture_end(self):
        self.log.append(("end",))

    def replay(self):
        self.log.append(("replay",))


class _FakeEvent:
    """torch.cuda.Event: its flags and records, logged in the graph log."""

    def __init__(self, enable_timing=False, external=False):
        self.flags = (enable_timing, external)

    def record(self):
        _FakeGraph.log.append(("event",) + self.flags)


def _fake_cuda(monkeypatch):
    """Patch the torch.cuda calls graphs.capture makes, so that its cuts
    run on the CPU: each graph's capture and event record is logged,
    nothing is recorded."""
    _FakeGraph.log = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 0)


def test_capture_cuts_a_chain_at_its_marks(monkeypatch):
    """graphs.capture with chain=True makes one graph per stage, each begun
    in the runner's pool in the thread-local error mode and ended at its
    stage's mark, each holding its own stage's kernel launches, which the
    capture takes back out of kernels.LAUNCHES; without chain the same run
    is one graph holding them all."""
    _fake_cuda(monkeypatch)

    def run(mark):
        for k in ("ntt", "firstdim", "fold"):
            kernels.LAUNCHES[k] += 1
            mark()
        return (torch.zeros(1),)

    before = dict(kernels.LAUNCHES)
    graphs_, out = graphs.capture(run, 3, str, CPU, pool="p", chain=True)
    assert dict(kernels.LAUNCHES) == before
    assert [g.launches[k] for g, k in zip(graphs_, ("ntt", "firstdim",
                                                     "fold"))] == [1, 1, 1]
    assert all(sum(g.launches.values()) == 1 for g in graphs_)
    assert _FakeGraph.log == [("begin", "p", "thread_local"),
                              ("end",)] * 3
    assert torch.equal(out[0], torch.zeros(1))
    (one,), _ = graphs.capture(run, 3, str, CPU)
    assert sum(one.launches.values()) == 3 and len(_FakeGraph.log) == 8
    assert dict(kernels.LAUNCHES) == before


def test_one_graph_capture_records_an_event_a_mark_plus_one(monkeypatch):
    """Captured as one graph on a CUDA device, a run's stage marks and one
    mark before its first stage are timing events recorded inside the
    capture as external (event-record) nodes, the graph's clock; a chain's
    graphs hold no clock."""
    _fake_cuda(monkeypatch)
    cuda = torch.device("cuda")

    def run(mark):
        for _ in range(3):
            mark()
        return (torch.zeros(1),)

    (one,), _ = graphs.capture(run, 3, str, cuda)
    assert len(one.clock.marks) == 4
    assert _FakeGraph.log == ([("begin", None, "thread_local")] +
                              [("event", True, True)] * 4 + [("end",)])
    chain, _ = graphs.capture(run, 3, str, cuda, chain=True)
    assert [g.clock for g in chain] == [None] * 3


def test_runner_counts_a_capture_a_new_key(monkeypatch):
    """On a CUDA device (stand-ins here) a program's first call is traced
    as "capture" inside "stage" and counts one capture; calls of a key it
    holds replay its graph and count none; the runner remembers the key it
    replayed last, whose clock is the graph's own."""
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(graphs, "static_inputs",
                        lambda sources, device: [s.parts[0].clone()
                                                 for s in sources])
    monkeypatch.setattr(graphs, "warm_up", lambda run, device: run())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "p")
    runner = graphs.GraphRunner(torch.device("cuda"), "test")

    def body(x, mark):
        mark()
        return (x + 1,)

    src = [graphs.Staged.whole(torch.zeros(2))]
    captures = tracing.COUNTS["captures"]
    tracing.enable(True)
    try:
        for key in (("single", False, 1), ("single", False, 1),
                    ("batch", False, 2)):
            (out,) = runner.run(key, body, src, ("all",))
            assert torch.equal(out, torch.ones(2)) and runner.last == key
        spans = {s.id: s for s in tracing.drain()}
    finally:
        tracing.enable(False)
    assert tracing.COUNTS["captures"] == captures + 2
    assert _FakeGraph.log.count(("replay",)) == 3
    prog = runner.programs[runner.last]
    assert prog.clock is prog.graphs[0].clock and len(prog.clock.marks) == 2
    caps = [s for s in spans.values() if s.name == "spiral.capture"]
    assert len(caps) == 2
    assert all(spans[s.parent].name == "spiral.stage" for s in caps)
    assert [s.name for s in spans.values()].count("spiral.replay") == 3


def test_failed_chain_capture_names_its_stage(monkeypatch):
    """A stage that fails in the capture raises RuntimeError naming that
    stage (what(i), i the stages marked before it), after ending the open
    capture and restoring the launch counts; a body that marks fewer
    stages than the chain has raises the same way."""
    _fake_cuda(monkeypatch)
    before = dict(kernels.LAUNCHES)
    names = ("expansion", "composition", "conversion")

    def failing(mark):
        mark()
        kernels.LAUNCHES["ntt"] += 1
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(RuntimeError, match="capture of composition failed"):
        graphs.capture(failing, 3, names.__getitem__, CPU, chain=True)
    assert _FakeGraph.log[-1] == ("end",) and len(_FakeGraph.log) == 4
    assert dict(kernels.LAUNCHES) == before
    with pytest.raises(RuntimeError, match="2 stage marks for 3 stages"):
        graphs.capture(lambda mark: (mark(), mark(), ())[2], 3,
                       names.__getitem__, CPU, chain=True)
    assert _FakeGraph.log[-1] == ("end",)


@pytest.mark.parametrize("name", PRESETS)
def test_batches_served_twice_and_two_sizes(name):
    """A batch of 2 served twice gives its eager rows both times; a batch
    of 3 in the same server gets a program of its own; every answer
    decodes, and each call's stage split (the runner's own eager run,
    marked, on the CPU) is in last_timings."""
    client, server, pts = _serve(name)
    queries = [client.query(i) for i in IDXS]
    direct = queries[0].packed_b is None
    first, _ = server.process_query_batch(queries[:2])
    timings = server.last_timings
    again, seconds = server.process_query_batch(queries[:2])
    assert seconds > 0 and timings.total_us > 0
    assert server.last_timings is not timings
    eager = server._run_batch(queries[:2])
    for b, resp in enumerate(first):
        assert all(np.array_equal(x, interop.to_numpy(e[b]).astype(object))
                   for x, e in zip(interop.response_rows(resp), eager))
    for a, b in zip(first, again):
        for x, y in zip(interop.response_rows(a), interop.response_rows(b)):
            np.testing.assert_array_equal(x, y)
    three, _ = server.process_query_batch(queries[1:])
    assert set(server.graphs.programs) == {("batch", direct, 2),
                                           ("batch", direct, 3)}
    for i, resp in zip(IDXS[:2] + IDXS[1:], first + three):
        np.testing.assert_array_equal(client.decode(resp),
                                      pts[i].astype(object))
    server.release_graphs()
    assert not server.graphs.programs


def _jax_pub(tpub) -> JPublicParams:
    """A JAX PublicParams of the port's arrays."""
    f = interop.public_params_to_numpy(tpub)
    mats = [[PolyMat(jnp.asarray(w), True) for w in f[k]]
            for k in ("W_exp_left", "W_exp_right")]
    return JPublicParams(W_exp_left=mats[0], W_exp_right=mats[1],
                         W_conv=PolyMat(jnp.asarray(f["W_conv"]), True),
                         V=PolyMat(jnp.asarray(f["V"]), True))


@pytest.fixture(scope="module")
def jax_tiny():
    """(client, server, queries at IDXS, each query's rows from one JAX
    SpiralServer's _run_single (its one-dispatch full_packed program) over
    the same records and public parameters) at tiny, made once."""
    client, server, pts = _serve("tiny")
    jp = jpreset("tiny")
    jserver = jpir.SpiralServer(jp, j_encode_db(pts, jp),
                                _jax_pub(server.pub))
    queries = [client.query(i) for i in IDXS]
    want = []
    for q in queries:
        f = interop.query_to_numpy(q)
        want.append([np.asarray(w) for w in jserver._run_single(JQuery(
            seed=f["seed"], packed_b=jnp.asarray(f["packed_b"])))])
    return client, server, queries, want


def test_tiny_rows_equal_jax_run_single(jax_tiny):
    """Four of the port client's queries through _run_single back to back:
    each query's rows equal the JAX server's _run_single rows."""
    _, server, queries, want = jax_tiny
    outs = [server._run_single(q) for q in queries]
    for rows, w in zip(outs, want):
        for got, x in zip(rows, w):
            np.testing.assert_array_equal(interop.to_numpy(got), x)


def test_stage_chain_rows_equal_jax(jax_tiny):
    """The same four queries through process_query, the stage chain, in
    turn on one server: each query's rows equal the JAX server's, and the
    chain's six stages are timed (the host clock here)."""
    _, server, queries, want = jax_tiny
    for q, w in zip(queries, want):
        resp, timings = server.process_query(q)
        for got, x in zip(interop.response_rows(resp), w):
            np.testing.assert_array_equal(got, x.astype(object))
        assert all(getattr(timings, f"{s}_us") > 0 for s in SPIRAL_STAGES)
    assert ("stages", False, 1) in server.graphs.programs


def test_factored_served_tail():
    """A factored server's process_query_fused serves its query stages as
    a chain and its tail (first dim, fold, modulus switch) through the
    runner on the query stages' staged outputs: two queries in turn, each
    equal to its process_query rows (its own chain) and decoded chunk by
    chunk, last_timings holding the tail's three stages; _run_single
    serves the whole query."""
    tp = preset("tiny")
    client = SpiralClient(tp, seed=4, device="cpu")
    pts = np.random.default_rng(5).integers(
        0, tp.p_db, size=(tp.total_n, 3, tp.n0, tp.n2, tp.poly_len))
    server = factored.FactoredSpiralServer(
        tp, factored.encode_factored_db(pts, tp, "cpu"), client.setup())
    for idx in (IDXS[1], IDXS[3]):
        q = client.query(idx)
        got, seconds = server.process_query_fused(q)
        tail = server.last_timings
        assert tail.db_independent_us == 0 and tail.folding_us > 0
        assert tail.first_multiply_us > 0 and tail.modswitch_us > 0
        want, _ = server.process_query(q)
        assert seconds > 0 and len(got) == 3
        for a, b in zip(got, want):
            for x, y in zip(interop.response_rows(a),
                            interop.response_rows(b)):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(factored.decode_factored(client, got),
                                      pts[idx].astype(object))
        assert _equal_rows(server._run_single(q), server._run_eager(q))
    assert set(server.graphs.programs) == {
        ("query_stages", False, 1), ("tail", False, 1), ("stages", False, 1),
        ("single", False, 1)}


def test_staging_refuses_what_it_cannot_serve():
    """A batch that mixes forms, an empty batch and parts that do not fill
    their static input raise ValueError."""
    client, server, _ = _serve("tiny")
    sclient, _, _ = _serve("tiny_stream")
    with pytest.raises(ValueError, match="mixes"):
        server.process_query_batch([client.query(1), sclient.query(1)])
    with pytest.raises(ValueError, match="empty"):
        server.process_query_batch([])
    staged = graphs.Staged((3, 2), [torch.zeros(2, 2, dtype=torch.int32)])
    with pytest.raises(ValueError, match="staged rows"):
        graphs.static_inputs([staged], CPU)
