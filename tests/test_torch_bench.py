"""The port's bench (spiral_tpu_torch/bench.py) on the CPU at the tiny
presets: one JSON line with exactly bench.py's keys plus
detail.stage_basis and detail.serving ("eager" here), correct decodes,
and db_bytes and response_bytes equal to bench.py's formulas on the JAX
package's Params.  Runs in-process."""
import json
import math

import pytest

from spiral_tpu.params import preset as jpreset
from spiral_tpu_torch import bench

TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
# bench.py:262-286, the single-query branch's detail
SINGLE_DETAIL = {
    "preset", "timing", "correct", "db_bytes", "server_total_s",
    "single_query_wall_s", "vs_baseline_single_query", "host_rtt_floor_s",
    "pipelined_s", "expansion_us", "composition_us", "conversion_us",
    "first_multiply_us", "folding_us", "modswitch_us", "fused_total_us",
    "query_bytes", "response_bytes"}
# bench.py:220-223 and :260-261, skipped under --implicit (bench.py:213)
BATCH8 = {"batch8_seconds", "batch8_queries_per_s", "batch8_agg_MBps"}
# bench.py:148-161, the --batch branch's detail
BATCH_DETAIL = {"preset", "batch", "correct", "db_bytes", "batch_seconds",
                "queries_per_s", "query_bytes", "response_bytes"}

CASES = {
    "tiny": ["--preset", "tiny"],
    "tiny_pack": ["--preset", "tiny_pack"],
    "tiny_stream": ["--preset", "tiny_stream"],
    "tiny_implicit": ["--preset", "tiny", "--implicit",
                      "--slab-bytes", str(1 << 16)],
    "tiny_batch": ["--preset", "tiny", "--batch", "3"],
}


def _jax_db_bytes(name: str, batch: bool) -> int:
    """bench.py:249-251 (single query) and :145-146 (--batch, n0*n2 polys
    a record for every preset) on the JAX Params."""
    p = jpreset(name)
    pt_bits = int(math.log2(p.p_db))
    pack = "pack" in name and not batch
    pt_polys = p.out_n ** 2 if pack else p.n0 * p.n2
    return p.total_n * pt_polys * p.poly_len * pt_bits // 8


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_json_contract(case, capsys):
    argv = CASES[case]
    rc = bench.main(argv + ["--device", "cpu", "--trials", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert set(out) == TOP_KEYS
    assert out["metric"] == "spiral_server_throughput"
    assert out["unit"] == "MB/s"
    detail = out["detail"]
    name = argv[1]
    batch = "--batch" in argv
    implicit = "--implicit" in argv
    assert detail["serving"] == "eager"
    if batch:
        assert set(detail) == BATCH_DETAIL | {"serving"}
    else:
        want = SINGLE_DETAIL | {"stage_basis", "serving"} | (
            set() if implicit else BATCH8)
        assert set(detail) == want
        assert detail["stage_basis"].startswith("host_clock")
        assert ("direct query" in detail["stage_basis"]) == (
            "stream" in name)
        stages = [detail[k] for k in SINGLE_DETAIL if k.endswith("_us")]
        assert all(isinstance(v, int) and v >= 0 for v in stages)
    assert detail["correct"] is (None if implicit else True)
    assert detail["db_bytes"] == _jax_db_bytes(name, batch)
    assert detail["response_bytes"] == jpreset(name).response_size_bytes()
    assert detail["preset"] == name
