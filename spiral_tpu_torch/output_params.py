"""Dump chosen parameters / results from saved figure files as JSON (the
port's counterpart of spiral_tpu/output_params.py; ref:
output_params.py:1-45 — the reference reads result pickles; here figures
persist JSON via harness.save_results).

    python -m spiral_tpu_torch.output_params results_torch/table_results.json
    python -m spiral_tpu_torch.output_params --params --pretty \
        results_torch/limits_results.json spiralstream
"""
from __future__ import annotations

import argparse
import json
import sys


def process_rows(rows: list, schemes: list[str], params_only: bool) -> list:
    out = []
    for row in rows:
        name = row.get("variant") or row.get("system") or ""
        if schemes and name not in schemes:
            continue
        if params_only:
            if "params" not in row:
                continue
            out.append({"variant": name, "params": row["params"]})
        else:
            out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Output parameters/results as JSON.")
    ap.add_argument("--full", action="store_true",
                    help="output the file verbatim")
    ap.add_argument("--params", action="store_true",
                    help="only output chosen parameters")
    ap.add_argument("--pretty", action="store_true")
    ap.add_argument("figurefile")
    ap.add_argument("schemes", nargs="*",
                    help="only include these schemes/variants")
    args = ap.parse_args(argv)

    with open(args.figurefile) as f:
        rows = json.load(f)
    if not args.full:
        rows = process_rows(rows, args.schemes, args.params)
    print(json.dumps(rows, sort_keys=True,
                     indent=4 if args.pretty else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
