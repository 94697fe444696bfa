"""The frozen client's SPQ2 and SPP1 bytes served by the port's CPU server,
and its responses decoded by the plain reference to the benchmark's
records, over every path a cell drives: one query at a time, a batch, a
factored database, and the stage chain."""
import pytest

from pirbench.cell import run_cell
from pirbench.tests.conftest import BATCH, SINGLE, tiny_config


@pytest.mark.parametrize("factor, traffic, traced", [
    (1, SINGLE, True), (3, SINGLE, True), (1, BATCH, False)],
    ids=["single", "factored", "batch"])
def test_served_answers_decode_to_records(factor, traffic, traced, t0):
    out = run_cell(tiny_config(factor), traffic, 2**31 + 7, 0.3, traced,
                   "cpu", t0)
    run = out["run"]
    assert out["check"]["wrong_answers"] == 0
    # warm-up, window, traced steps and chain all answered and checked
    served = traffic.batch * (traffic.warm_steps + len(run.steps) +
                              (traffic.trace_steps if traced else 0))
    chain = traffic.chain_runs if traced else 0
    assert out["attempted"] == out["check"]["answers"] == served + chain
    assert len(run.latencies) == traffic.batch * len(run.steps) > 0
    # set-up leaves out the benchmark's client making its queries
    ph = out["phases"]
    assert run.setup_s == pytest.approx(
        ph["warm"] - (ph["client"] - ph["records"]))
    if traced and traffic.chain_runs:
        assert len(run.chain) == traffic.chain_runs - 1


def test_same_seed_same_inputs():
    import numpy as np

    from pirbench.cell import draw_records
    from pirbench.reference.client import PlainClient
    from pirbench.reference.scheme import SchemeParams
    from pirbench.reference import wire

    sp = SchemeParams.from_config(tiny_config()["params"])
    a, b = (draw_records(sp, 2, 2**31 + 3, "cpu", np.int16)
            for _ in range(2))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    qa, qb = ([wire.query_to_bytes(q) for q in
               PlainClient(sp, 2**31 + 3).queries([1, 5])] for _ in range(2))
    assert qa == qb and qa[0] != qa[1]
