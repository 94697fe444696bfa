"""Configurations, traffic mixes and metrics are found by name: every
entry of BENCHMARK.json has its file under pirbench/, and the harness
loads each by the name alone."""
import json
import types
from pathlib import Path

import pytest

from pirbench import cell, run as runmod
from pirbench.reference.scheme import SchemeParams
from pirbench.workload import Traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    config = cell.load_config(cfg["name"])
    assert (ROOT / cfg["file"]).resolve() == \
        (ROOT / "pirbench" / "configs" / f"{cfg['name']}.json").resolve()
    assert config["source"] == cfg["source"] and config["reduced"] == \
        cfg["reduced"]
    sp = SchemeParams.from_config(config["params"])
    assert sp.total_n * config["factor"] * sp.n0 * sp.n2 * sp.poly_len >= \
        config["database"]["records"] * config["database"]["record_bytes"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_found_by_name(w):
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    t = Traffic.load(w["traffic"])
    assert t.name == w["traffic"] and t.batch >= 1
    # each cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = runmod.cell_metrics(BENCH, w["name"], False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert runmod.cell_metrics(BENCH, w["name"], True)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_found_by_name(m):
    assert callable(runmod.load_metric(m["name"]))
    if "moves" in m:
        moved = {e["name"] for e in BENCH["end_to_end"]}
        assert m["moves"] in moved


def test_pool_is_distinct_and_seeded():
    t = Traffic.load("single")
    a, b = t.pool_indices(32768, 2**31 + 1), t.pool_indices(32768, 2**31 + 1)
    assert (a == b).all() and len(set(a.tolist())) == t.pool
    assert len(t.pool_indices(16, 5)) == t.pool
    assert t.step(0) == [0] and Traffic.load("batch8").step(1) == \
        list(range(8, 16))


def test_open_loop_refused(tmp_path):
    (tmp_path / "open.json").write_text(json.dumps(
        {"loop": "open", "batch": 1, "pool": 4, "warm_steps": 1,
         "trace_steps": 1, "chain_runs": 0}))
    with pytest.raises(ValueError, match="closed"):
        Traffic.load("open", tmp_path)


def test_idle_pct_reads_an_untraced_step():
    """Busy seconds a step from the trace over the untraced window's
    seconds a step; a `.batch` name is read by the same file."""
    from pirbench.trace import TraceSummary
    trace = TraceSummary(window_s=1.0, busy_s=0.06, kernels={"k": (10, 0.06)},
                         idle_by_span={})
    run = types.SimpleNamespace(trace=trace, trace_steps=10,
                                steps=[()] * 100, window_s=0.8)
    for name in ("idle_pct", "idle_pct.batch"):
        assert runmod.load_metric(name)(run) == pytest.approx(25.0)
    assert runmod.load_metric("idle_pct")(
        types.SimpleNamespace(trace=None, trace_steps=0, steps=[],
                              window_s=0)) is None
