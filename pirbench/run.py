"""Run one cell of the benchmark once:

    python3 -m pirbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json.  The cell names a
configuration (pirbench/configs/<name>.json) and a traffic mix
(pirbench/traffic/<name>.json); its metrics are read by
pirbench/metrics/<metric>.py.  With --trace 0 the result holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), then checks, each
number compared beside its limit; the same numbers are the last lines of
standard error.  The run exits with another code than 0, and prints no
result, when the card is missing, when the program cannot be imported, or
when the JAX package or JAX was loaded in this process.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "spiral_tpu")


def loaded_forbidden() -> list[str]:
    """FORBIDDEN names among the loaded modules, compared by whole
    top-level name (spiral_tpu_torch is not spiral_tpu)."""
    tops = {name.split(".")[0] for name, mod in list(sys.modules.items())
            if mod is not None}
    return sorted(tops.intersection(FORBIDDEN))


def load_metric(name: str):
    """The reader of metric `name`: pirbench/metrics/<name>.py's read.  A
    quantity split by the end-to-end metric it moves (`wire_us.batch`) is
    read by the file of its first part (`wire_us.py`) unless it has one of
    its own."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"pirbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones untraced,
    its per-layer ones traced (those listing it, or listing no cells)."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def card_line() -> str:
    """nvidia-smi's name, clocks and power limit of each card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
         "power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().replace("\n", " | ")


def result_line(bench: dict, cell: dict, out: dict, traced: bool,
                kind: str) -> dict:
    """The result's JSON object of a finished run_cell."""
    from .check import LIMITS
    run, verdict = out["run"], out["check"]
    metrics = {}
    for m in cell_metrics(bench, cell["name"], traced):
        value = load_metric(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(verdict[name] <= limit
                             for name, limit in LIMITS.items()),
              "attempted": out["attempted"],
              "failed": verdict["wrong_answers"], "metrics": metrics,
              "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {name: {"value": verdict[name], "limit": limit}
                        for name, limit in LIMITS.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads(Path("BENCHMARK.json").read_text())
    (cell,) = [w for w in bench["workloads"] if w["name"] == args.workload]

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"pirbench: the cell needs {cell['chips']} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    print("pirbench: cards:", card_line(), flush=True)

    from .cell import load_config, run_cell
    from .workload import Traffic
    config = load_config(cell["config"])
    traffic = Traffic.load(cell["traffic"])
    out = run_cell(config, traffic, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_PROCESS)
    found = loaded_forbidden()
    if found:
        print(f"pirbench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3

    result = result_line(bench, cell, out, bool(args.trace),
                         torch.cuda.get_device_name(0))
    run = out["run"]
    medians = [statistics.median(s[i] for s in run.steps) * 1e3
               for i in range(3)] if run.steps else []
    print(f"pirbench: {out['attempted']} answers checked, window "
          f"{run.window_s:.3f} s, {len(run.steps)} steps (median ms a step: "
          f"parse, serve, pack {medians}); seconds from the process's "
          f"start: {json.dumps(out['phases'])}", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
