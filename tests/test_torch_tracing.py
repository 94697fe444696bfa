"""The port's program tracing (spiral_tpu_torch/tracing.py) on a CPU server at
tiny: off, nothing is recorded and no spiral.* event reaches a running
profiler; on, a query and a batch of 2 served from wire bytes to wire bytes
(parse, serve, pack) give the spans of the served path, nested as the
program nests its calls, one request id a served call, each also a
profiler event; the query counter counts either way; and last_timings
holds the six stages of each served call.  The database encoder's
spiral.encode spans (one a sub-database) and its encoded_bytes count."""
import collections

import numpy as np
import pytest
import torch

from spiral_tpu_torch import factored, pir, serialize, tracing
from spiral_tpu_torch.params import preset
from spiral_tpu_torch.pir import SPIRAL_STAGES, SpiralClient, SpiralServer
from spiral_tpu_torch.server.db import encode_db, random_db

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def served():
    """(params, server, two SPQ2 queries' bytes) at tiny."""
    p = preset("tiny")
    client = SpiralClient(p, seed=8, device="cpu")
    pts = random_db(p, np.random.default_rng(9))
    server = SpiralServer(p, encode_db(pts, p, CPU), client.setup())
    wire = [serialize.query_to_bytes(client.query(i), p) for i in (3, 12)]
    yield p, server, wire
    tracing.enable(False)
    tracing.drain()


def _single(p, server, data: bytes) -> bytes:
    """One query from its bytes to its response's bytes, as a server loop
    serves it."""
    q = serialize.query_from_bytes(data, p, CPU)
    resp = server._response(*pir.serve_single(server, q))
    return serialize.response_to_bytes(resp, p)


def _profiled(run) -> list[str]:
    """The names of the CPU profiler's events while run() runs."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return [e.name for e in prof.events()]


def test_tracing_off_records_nothing(served):
    """Off, a served query records no span, and its host work outside the
    replay (parse, response, pack; the profiler's cost grows with the
    replay's ops) opens no profiler event; the query is counted."""
    p, server, wire = served
    tracing.enable(False)
    tracing.drain()
    queries = tracing.COUNTS["queries"]
    rows = pir.serve_single(server, serialize.query_from_bytes(wire[0], p,
                                                               CPU))

    def host_work():
        serialize.query_from_bytes(wire[1], p, CPU)
        with tracing.span("serve"):
            serialize.response_to_bytes(server._response(*rows), p)

    names = _profiled(host_work)
    assert tracing.drain() == []
    assert not [n for n in names if n.startswith("spiral.")]
    assert tracing.COUNTS["queries"] == queries + 1


def test_spans_of_a_query_and_a_batch(served):
    p, server, wire = served
    queries = tracing.COUNTS["queries"]
    tracing.drain()
    tracing.enable(True)
    try:
        names = _profiled(lambda: _single(p, server, wire[0]))
        single = server.last_timings
        qs = [serialize.query_from_bytes(b, p, CPU) for b in wire]
        resps, _ = server.process_query_batch(qs)
        batch = server.last_timings
        [serialize.response_to_bytes(r, p) for r in resps]
        spans = tracing.drain()
    finally:
        tracing.enable(False)
    for t in (single, batch):
        assert all(getattr(t, f"{s}_us") > 0 for s in SPIRAL_STAGES)
    assert tracing.COUNTS["queries"] == queries + 3
    by_id = {s.id: s for s in spans}

    def children(s):
        return sorted(c.name for c in spans if c.parent == s.id)

    # the query's response is made by the caller, the batch's inside serve
    tops = collections.Counter(s.name for s in spans if s.parent is None)
    assert tops == {"spiral.parse": 3, "spiral.serve": 2,
                    "spiral.response": 1, "spiral.pack": 3}
    serves = sorted((s for s in spans if s.name == "spiral.serve"),
                    key=lambda s: s.start_ns)
    assert [s.request for s in serves] == [queries, queries + 1]
    assert children(serves[0]) == ["spiral.replay", "spiral.stage"]
    assert children(serves[1]) == ["spiral.replay", "spiral.response",
                                   "spiral.stage"]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.request is None or s.name == "spiral.serve"
            continue
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
        assert s.request == parent.request
        if s.name == "spiral.fetch":
            assert parent.name == "spiral.response"
    responses = [s for s in spans if s.name == "spiral.response"]
    assert all(children(r) == ["spiral.fetch"] for r in responses)
    # each span of the first query is also the profiler's event
    assert {n for n in names if n.startswith("spiral.")} == {
        "spiral.parse", "spiral.serve", "spiral.stage", "spiral.replay",
        "spiral.response", "spiral.fetch", "spiral.pack"}


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_encode_spans_and_bytes(on):
    """encode_factored_db at F = 4: on, one spiral.encode span a
    sub-database, outside any served call; on or off, encoded_bytes grows
    by the encoded tensor's bytes; off, no span."""
    p = preset("tiny")
    rng = np.random.default_rng(10)
    subs = [random_db(p, rng) for _ in range(4)]
    before = tracing.COUNTS["encoded_bytes"]
    tracing.drain()
    tracing.enable(on)
    try:
        db = factored.encode_factored_db(iter(subs), p, CPU, factor=4)
        spans = tracing.drain()
    finally:
        tracing.enable(False)
    assert tracing.COUNTS["encoded_bytes"] - before == \
        db.data.numel() * db.data.element_size()
    if not on:
        assert spans == []
        return
    assert [s.name for s in spans] == ["spiral.encode"] * 4
    assert all(s.parent is None and s.request is None and
               s.start_ns <= s.end_ns for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
