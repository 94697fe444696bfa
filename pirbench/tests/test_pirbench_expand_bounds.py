"""The frozen K4 bound (pirbench/expand_bounds.py) equals chip_smoke.py's
phase 3b count at the spiral_20_256 shapes, and k4_roofline reads it
against a trace's K4 time."""
import importlib.util
import json
import types
from pathlib import Path

import pytest

from pirbench import expand_bounds, run as runmod
from pirbench.cell import load_config
from pirbench.reference.scheme import SchemeParams
from pirbench.trace import TraceSummary

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_expand",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def params(name: str) -> SchemeParams:
    return SchemeParams.from_config(load_config(name)["params"])


def test_k4_bound_is_chip_smokes(smoke):
    """time_expand_launches' sum of bounds: each launch's inputs cv, ca
    (N, 2, 1, 2, d), W (2, m, 2, d) and output (N, 2, 1, 2, d), words of
    4 bytes, against expand_products over the memory and product peaks."""
    p = params("spiral_20_256")
    d = p.poly_len
    launches = smoke.expand_launches("spiral_20_256")
    assert launches == expand_bounds.expand_launches(p)
    total = 0.0
    for _, _, N, m in launches:
        nbytes = (3 * N * 2 * 1 * 2 * d + 2 * m * 2 * d) * 4
        prods = smoke.expand_products(N, m, d)
        assert prods == expand_bounds.expand_products(N, m, d)
        total += max(nbytes / smoke.HBM_BYTES_PER_S,
                     prods / smoke.INT_PRODUCTS_PER_S)
    assert expand_bounds.k4_s(p) == pytest.approx(total, rel=1e-12)
    # PERF.md's 16 launches of a spiral_20_256 query: 0.0317 ms
    assert len(launches) == 16 and round(total * 1e3, 4) == 0.0317


def test_k4_launches_at_spiral_18_30000():
    """dim0 1,024: 11 rounds, stopround 7; 2,047 even-side cts at m 32
    and 200 odd-side ones at m 56 (73 in round 7)."""
    p = params("spiral_18_30000")
    launches = expand_bounds.expand_launches(p)
    assert (p.g, p.stopround, len(launches)) == (11, 7, 19)
    even = [(N, m) for side, _, N, m in launches if side == "even"]
    odd = [(N, m) for side, _, N, m in launches if side == "odd"]
    assert sum(N for N, _ in even) == 2047 and {m for _, m in even} == {32}
    assert sum(N for N, _ in odd) == 200 and {m for _, m in odd} == {56}
    assert odd[-1][0] == 73


def test_k4_roofline_reads_the_trace():
    """The bound times the queries of the traced steps over K4's traced
    seconds, K4 found by its kernel's name; None without a trace or
    without K4 in it."""
    p = params("spiral_18_30000")
    bound = expand_bounds.k4_s(p)
    kernels = {"void_expand_keyswitch_kernel_11__unsigned_int": (19 * 40,
                                                                 0.12),
               "void_firstdim_kernel_2": (40, 0.9)}
    trace = TraceSummary(window_s=2.0, busy_s=1.5, kernels=kernels,
                         idle_by_span={})
    run = types.SimpleNamespace(params=p, trace=trace, trace_steps=40,
                                batch=1, factor=4)
    read = runmod.load_metric("k4_roofline")
    assert read(run) == pytest.approx(100.0 * 40 * bound / 0.12)
    assert 0 < read(run) < 100
    # a step of B queries runs B queries' launches
    batch = types.SimpleNamespace(params=p, trace=trace, trace_steps=40,
                                  batch=2, factor=4)
    assert read(batch) == pytest.approx(2 * read(run))
    assert read(types.SimpleNamespace(params=p, trace=None, trace_steps=0,
                                      batch=1)) is None
    untouched = TraceSummary(window_s=1.0, busy_s=0.5,
                             kernels={"void_firstdim_kernel_2": (1, 0.5)},
                             idle_by_span={})
    assert read(types.SimpleNamespace(params=p, trace=untouched,
                                      trace_steps=1, batch=1)) is None


def test_k4_roofline_lists_the_new_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == "k4_roofline"]
    assert m["workloads"] == ["spiral_18_30000.single"]
    assert m["moves"] == "latency_p50_ms" and m["unit"] == "%"
