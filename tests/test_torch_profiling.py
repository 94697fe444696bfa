"""The port's stage profiler (spiral_tpu_torch/profiling.py) on the CPU at
the tiny presets, where the served runner runs its stages eagerly on the
host clock: the JAX profiler's keys as non-negative ints, a server whose
responses are unchanged by profiling, the profiled runs' rows equal to
the eager rows, and a refusal of the servers and queries the JAX
profiler does not take.  No timing relation is asserted here, where
eager stages are noisy; the stage sum against fused_total_us is checked
on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from spiral_tpu_torch import interop, profiling
from spiral_tpu_torch.pack import PackServer, encode_pack_db, random_pack_db
from spiral_tpu_torch.pack import PackClient
from spiral_tpu_torch.params import preset
from spiral_tpu_torch.pir import SpiralClient, SpiralServer
from spiral_tpu_torch.server.db import encode_db, random_db

# spiral_tpu/profiling.py:80-87: the names and fused_total_us
JAX_KEYS = {"expansion_us", "composition_us", "conversion_us",
            "first_multiply_us", "folding_us", "modswitch_us",
            "fused_total_us"}
CPU = torch.device("cpu")


def _server(name: str):
    p = preset(name)
    client = SpiralClient(p, seed=3, device="cpu")
    pts = random_db(p, np.random.default_rng(4))
    return client, SpiralServer(p, encode_db(pts, p, CPU), client.setup()), \
        pts


def test_stage_times_keys_and_server_unchanged():
    client, server, pts = _server("tiny")
    q = client.query(11)
    before, _ = server.process_query(q)
    out = profiling.device_stage_times(server, q, iters=2, reps=1)
    after, _ = server.process_query(q)
    assert set(out) == JAX_KEYS
    assert all(type(v) is int and v >= 0 for v in out.values())
    for a, b in zip(interop.response_rows(before),
                    interop.response_rows(after)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(client.decode(after),
                                  pts[11].astype(object))


def test_prefix_rows_equal_eager_rows():
    """The profiled runs of the served program, on its staged inputs, leave
    the eager rows (_run_eager's, and _run_single's) in its outputs, and
    its last run's clock holds one interval a stage."""
    client, server, _ = _server("tiny")
    q = client.query(5)
    profiling.device_stage_times(server, q, iters=1, reps=2)
    prog = server.graphs.programs[("single", False, 1)]
    assert len(prog.clock.intervals_us()) == len(profiling.STAGES)
    for a, b, c in zip(prog.outputs, server._run_eager(q),
                       server._run_single(q)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_direct_query_raises():
    client, server, _ = _server("tiny_stream")
    q = client.query(2)
    assert q.packed_b is None
    with pytest.raises(ValueError, match="packed query"):
        profiling.device_stage_times(server, q)


def test_pack_server_raises():
    p = preset("tiny_pack")
    client = PackClient(p, seed=3, device="cpu")
    pts = random_pack_db(p, np.random.default_rng(4))
    server = PackServer(p, encode_pack_db(pts, p, CPU), client.setup())
    with pytest.raises(ValueError, match="SpiralServer"):
        profiling.device_stage_times(server, client.query(2))
