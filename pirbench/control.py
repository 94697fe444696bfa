"""The control of a cell's check: the cell run with its configuration's
``control`` parameters (a lower-precision modulus switch, program and
client alike), which break the configuration's guarantee that every
answer decodes exactly.  Its runs have to come out not correct; the
benchmark's own runs never run it.

    python3 -m pirbench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

prints one JSON line a seed: the control's wrong answers beside the
answers checked.  All seeds run in one process.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("pirbench.control: no CUDA device", file=sys.stderr)
        return 2
    from .cell import load_config, run_cell
    from .workload import Traffic

    bench = json.loads(Path("BENCHMARK.json").read_text())
    (cell,) = [w for w in bench["workloads"] if w["name"] == args.workload]
    config = load_config(cell["config"])
    override = {k: v for k, v in config["control"].items() if k != "why"}
    traffic = Traffic.load(cell["traffic"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run_cell(config, traffic, seed, args.seconds, False, "cuda",
                       t0, params_override=override)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control": override,
                          "wrong_answers": out["check"]["wrong_answers"],
                          "answers": out["check"]["answers"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
