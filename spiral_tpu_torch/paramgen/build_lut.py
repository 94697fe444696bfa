"""Measured stage-time LUT of the card (counterpart of
spiral_tpu/paramgen/build_lut.py; ref: select_params.py --build-exp-lut /
--build-fdim-lut, exp_lut*.json).

Runs configurations end to end on the card through the port's
harness.run_variant and records per-stage timings keyed like the JAX
package's LUT (lut_key is the same string, so the two LUTs compare entry
by entry); `search.select_params` prefers measured entries over the
analytic proxy when ranking.  Each entry records the card it ran on, as
nvidia-smi --query-gpu=name,power.limit prints it.

    python -m spiral_tpu_torch.paramgen.build_lut --stages \\
        --presets spiral_20_256,spiralpack_20_256 --grid 9:7:9,8:6:9

writes spiral_tpu_torch/paramgen/h100_lut.json unless --out names another
file; --device cpu measures on the CPU (tests pass a temporary --out).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np

DEFAULT_LUT = pathlib.Path(__file__).parent / "h100_lut.json"

# Bump whenever a serving kernel changes (a kernel PR refreshes the LUT on
# the card at the new tag): measured entries carry this tag, and the
# selection lookup (search._try_candidate) ignores entries from other
# generations instead of mis-ranking them against the analytic proxy.
# The tag names the Hopper kernels' last change, K8b's TMA-fed redesign.
KERNEL_VERSION = "h100-k8b-tma"


def lut_key(params) -> str:
    """Measured-entry key: includes every knob that changes the cost
    profile — dims, all gadget widths, plaintext modulus, and the upload
    form (the JAX package's key, string for string)."""
    return str((params.nu_1, params.nu_2, params.t_exp, params.t_exp_right,
                params.t_gsw, params.t_conv, params.p_db, params.out_n,
                params.query_elems_first, params.query_elems_rest,
                params.poly_len))


_LUT_CACHE: dict = {}


def load_lut(path=DEFAULT_LUT) -> dict:
    key = str(path)
    if key not in _LUT_CACHE:
        p = pathlib.Path(path)
        _LUT_CACHE[key] = json.loads(p.read_text()) if p.exists() else {}
    return _LUT_CACHE[key]


def card_name(device) -> str:
    """The card a measurement ran on, as nvidia-smi prints its name and
    power limit; "cpu" for a CPU run."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True).stdout.strip()


def measure(params, pack: bool, trials: int = 2, stages: bool = False,
            device="cuda") -> dict:
    from ..harness import run_variant
    rng = np.random.default_rng(0)
    name = "spiralpack" if pack else "spiral"
    row = run_variant(name, params, rng, trials=trials, want_stages=stages,
                      device=device)
    out = {
        "server_s": row["server_s"],
        "pipelined_s": row.get("pipelined_s"),
        "tput_MB_s": row["tput_MB_s"],
        "query_sz": row["query_b"],
        "resp_sz": row["resp_b"],
        "is_corr": row["correct"],
        "variant": name,
        "kernel_version": KERNEL_VERSION,
        "card": card_name(device),
        "params": dataclasses.asdict(params),
    }
    if stages:
        out["stages_us"] = row["stages_us"]
    return out


def analyze_deviation(lut: dict) -> list:
    """Model-vs-measured comparison per LUT entry (ref: select_params.py
    --analyze-deviation, :589-616): how far the analytic cost proxy is
    from the measured server time.  Large deviations mean rankings from
    the proxy are untrustworthy for that region; build measured entries
    there."""
    from ..params import Params
    from .search import h100_cost_proxy
    rows = []
    for key, entry in lut.items():
        p = Params(**entry["params"])
        pack = "pack" in str(entry.get("variant", ""))
        model_s = h100_cost_proxy(p, pack)
        meas = entry.get("pipelined_s") or entry["server_s"]
        stale = entry.get("kernel_version") != KERNEL_VERSION
        rows.append({"key": key, "measured_s": meas,
                     "model_s": round(model_s, 4),
                     "ratio": round(meas / model_s, 3) if model_s else None,
                     "is_corr": entry.get("is_corr"),
                     "stale_kernel": stale})
    return rows


def grid_params(spec: str):
    """"nu1:nu2:tgsw" -> a valid spiral Params (q' from the 2^-40 noise
    search), or None when the shape fails the correctness bar.  Used to
    widen the measured LUT beyond the shipped presets (the reference
    measures a 48-entry (nu1, nu2, t_exp) grid — select_params.py:451-518)."""
    from ..params import Params
    from .search import candidate_ok
    nu_1, nu_2, t_gsw = (int(x) for x in spec.split(":"))
    base = Params(nu_1=nu_1, nu_2=nu_2, p_db=256, t_gsw=t_gsw, t_conv=4,
                  t_exp=8, t_exp_right=56)
    res = candidate_ok(base, pack=False)
    if res is None:
        return None
    _, qbits = res
    return dataclasses.replace(base, q_prime_bits=qbits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--presets", default="tiny")
    ap.add_argument("--grid", default="",
                    help="extra nu1:nu2:tgsw shapes (comma-separated) "
                         "measured as spiral configs")
    ap.add_argument("--out", default=str(DEFAULT_LUT))
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--stages", action="store_true",
                    help="record the per-stage breakdown in each entry")
    ap.add_argument("--analyze-deviation", action="store_true",
                    help="print model-vs-measured deviation per entry "
                         "instead of measuring")
    ap.add_argument("--device", default="cuda",
                    help="the device the servers run on (default cuda)")
    args = ap.parse_args(argv)

    if args.analyze_deviation:
        rows = analyze_deviation(load_lut(args.out))
        print(json.dumps(rows, indent=1))
        return 0

    presets = [x for x in args.presets.split(",") if x]
    grid = [x for x in args.grid.split(",") if x]
    if len(presets) + len(grid) > 1:
        # one subprocess per measurement: each allocates a multi-GB DB,
        # and the caching allocator would hold it across runs
        jobs = ([("--presets", n) for n in presets] +
                [("--grid", g) for g in grid])
        for flag, name in jobs:
            cmd = [sys.executable, "-m", "spiral_tpu_torch.paramgen.build_lut",
                   "--presets", "", flag, name, "--out", args.out,
                   "--trials", str(args.trials), "--device", args.device]
            if args.stages:
                cmd.append("--stages")
            print(f"[build_lut] {name}", file=sys.stderr, flush=True)
            r = subprocess.run(cmd)
            if r.returncode != 0:
                print(f"[build_lut] {name} FAILED rc={r.returncode}",
                      file=sys.stderr, flush=True)
        lut = json.loads(pathlib.Path(args.out).read_text()) \
            if pathlib.Path(args.out).exists() else {}
        print(json.dumps({"entries": len(lut), "out": args.out}))
        return 0

    from ..params import preset
    lut = dict(load_lut(args.out))
    for name in presets:
        params = preset(name)
        pack = "pack" in name
        print(f"measuring {name}...", file=sys.stderr, flush=True)
        lut[lut_key(params)] = measure(params, pack, args.trials,
                                       stages=args.stages,
                                       device=args.device)
    for spec in grid:
        params = grid_params(spec)
        if params is None:
            print(f"grid {spec}: fails correctness bar, skipped",
                  file=sys.stderr, flush=True)
            continue
        print(f"measuring grid {spec}...", file=sys.stderr, flush=True)
        lut[lut_key(params)] = measure(params, False, args.trials,
                                       stages=args.stages,
                                       device=args.device)
    pathlib.Path(args.out).write_text(json.dumps(lut, indent=1))
    _LUT_CACHE[str(args.out)] = lut
    print(json.dumps({"entries": len(lut), "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
