"""Cross-system benchmark adapters of the port (counterpart of
spiral_tpu/run_scheme.py; ref: run_scheme.py, util.py).

Runs one PIR system on one (logN, itemsize) scenario and returns the
reference's result-dict schema, so figure code comparing Spiral against
SealPIR / FastPIR / OnionPIR / NoPriv ports directly:

    non-streaming: {"total_us", "resp_sz", "query_sz", ...}
    streaming:     {"tput", "resp_sz", "item_sz", "query_sz", ...}

Spiral variants run the port's pipeline via ``python -m
spiral_tpu_torch.select_params`` (the same process boundary the reference
uses, ref: run_scheme.py:32-48), on the card unless --device says
otherwise (passed on through cmd_extras).  Competitor adapters shell out
to external binaries and regex-scrape their stdout exactly as the
reference does (ref: run_scheme.py:66-182); binary locations come from
the environment (SEALPIR_BIN / FASTPIR_BIN / ONIONPIR_BIN) instead of the
reference's hard-coded paths, and a missing binary raises
SystemUnavailable rather than crashing mid-figure.

    python -m spiral_tpu_torch.run_scheme spiral 20 256 [--stream] \
        [--trials N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys

SYSTEMS = ("sealpir", "fastpir", "onionpir", "spiralstream", "spiral",
           "spiralstream-pack", "spiral-pack", "nopriv")

# Per-system max item bytes in one run; bigger items run `factor` times
# (ref: run_scheme.py:96,130,177 maxsize values, :12-18 get_factor).
MAX_ITEM_BYTES = {"sealpir": 3072, "fastpir": 9120, "onionpir": 30720}

# Public-parameter sizes for competitors (ref: util.py:3-7).
OTHER_PP_SZ = {"onionpir": 4600000, "fastpir": 1400000, "sealpir": 3400000}

BIN_ENV = {"sealpir": "SEALPIR_BIN", "fastpir": "FASTPIR_BIN",
           "onionpir": "ONIONPIR_BIN"}


class SystemUnavailable(RuntimeError):
    """The external competitor binary is not installed on this host."""


def get_factor(itemsize: int, maxsize: int) -> int:
    """Times an oversize item must be fetched (ref: run_scheme.py:12-18)."""
    return 1 if itemsize <= maxsize else math.ceil(itemsize / maxsize)


def get_pp_size(system: str, r: dict | None = None) -> int:
    """Public-parameter bytes per system (ref: util.py:9-14)."""
    if "spiral" in system:
        if "param_sz" in r:
            return r["param_sz"]
        return r["other_data"]["param_sz"]
    return OTHER_PP_SZ[system]


def _competitor_bin(system: str) -> str:
    path = os.environ.get(BIN_ENV[system], "")
    if not path or not os.path.exists(path):
        raise SystemUnavailable(
            f"{system} binary not found; set ${BIN_ENV[system]}")
    return path


# ---------------------------------------------------------------- analyzers
# Pure functions over captured stdout so they are unit-testable without
# the binaries.  Regexes are the reference's (run_scheme.py:71-77,
# 109-112, 145-149).

def analyze_sealpir(s: str, db_items_log2: int, itemsize: int, factor: int,
                    streaming: bool) -> dict:
    total_ms = int(re.search(
        r"\s+PIRServer reply generation time.*:\s+([0-9]+) ms", s).group(1))
    exp_ms = sum(int(i) for i in re.findall(
        r"Server: expansion time.*\s+([0-9]+) ms", s))
    query_sz_b = int(re.search(
        r"\s+Query size bytes.*:\s+([0-9]+)", s).group(1))
    resp_sz_b = int(re.search(
        r"\s+Reply size bytes.*:\s+([0-9]+)", s).group(1))
    if streaming:
        return {"tput": ((1 << db_items_log2) * itemsize)
                / ((total_ms - exp_ms) * 1000),
                "resp_sz": factor * resp_sz_b,
                "item_sz": factor * itemsize, "query_sz": query_sz_b}
    return {"total_us": (factor * (total_ms - exp_ms) + exp_ms) * 1000,
            "resp_sz": factor * resp_sz_b, "query_sz": query_sz_b}


def analyze_fastpir(s: str, db_items_log2: int, itemsize: int, factor: int,
                    streaming: bool) -> dict:
    total_us = int(re.search(
        r"\s+Response generation time.*:\s+([0-9]+)", s).group(1))
    query_sz_b = int(re.search(r"\s+Query size.*:\s+([0-9]+)", s).group(1))
    resp_sz_b = int(re.search(
        r"\s+Response size.*:\s+([0-9]+)", s).group(1))
    if streaming:
        return {"tput": ((1 << db_items_log2) * itemsize) / total_us,
                "resp_sz": factor * resp_sz_b,
                "item_sz": factor * itemsize, "query_sz": query_sz_b}
    return {"total_us": factor * total_us, "resp_sz": factor * resp_sz_b,
            "query_sz": query_sz_b}


def analyze_onionpir(s: str, db_items_log2: int, itemsize: int, factor: int,
                     streaming: bool) -> dict:
    exp_us = 1000 * (
        int(re.search(r"\s+Server: rlwe exansion time.*=\s+([0-9]+)",
                      s).group(1))
        + int(re.search(
            r"\s+Server: expand after first diemension.*=\s+([0-9]+)",
            s).group(1)))
    total_us = 1000 * int(re.search(
        r"\s+Main: PIRServer reply generation time.*:\s+([0-9]+)",
        s).group(1))
    resp_sz_b = int(re.search(
        r"\s+Reply size bytes.*:\s+([0-9]+)", s).group(1))
    query_sz_b = 63488  # fixed in the reference (run_scheme.py:152)
    if streaming:
        return {"tput": ((1 << db_items_log2) * itemsize)
                / (total_us - exp_us),
                "resp_sz": factor * resp_sz_b,
                "item_sz": factor * itemsize, "query_sz": query_sz_b}
    return {"total_us": factor * (total_us - exp_us) + exp_us,
            "resp_sz": factor * resp_sz_b, "query_sz": query_sz_b}


_ANALYZERS = {"sealpir": analyze_sealpir, "fastpir": analyze_fastpir,
              "onionpir": analyze_onionpir}


# ------------------------------------------------------------------ runners

def _run_competitor(system: str, db_items_log2: int, itemsize: int,
                    streaming: bool, show_output: bool) -> dict:
    maxsize = MAX_ITEM_BYTES[system]
    if streaming:
        itemsize = maxsize
    factor = get_factor(itemsize, maxsize)
    binary = _competitor_bin(system)
    run_size = min(itemsize, maxsize)
    if system == "fastpir":
        cmd = [binary, "-n", str(1 << db_items_log2), "-s", str(run_size)]
    else:
        cmd = [binary, str(db_items_log2), str(run_size)]
    s = subprocess.check_output(cmd, text=True)
    if show_output:
        print(s)
    return _ANALYZERS[system](s, db_items_log2, itemsize, factor, streaming)


def _run_spiral(system: str, db_items_log2: int, itemsize: int,
                streaming: bool, show_output: bool,
                cmd_extras: list[str] | None = None) -> dict:
    cmd = [sys.executable, "-m", "spiral_tpu_torch.select_params",
           str(db_items_log2), str(itemsize if not streaming else 1)]
    if "spiralstream" in system:
        cmd.append("--direct-upload")
    if "pack" in system:
        cmd.append("--pack")
    if cmd_extras:
        cmd.extend(cmd_extras)
    s = subprocess.check_output(cmd, text=True)
    if show_output:
        print(s)
    obj = json.loads(s.splitlines()[-1])
    if streaming:
        return {"tput": obj["dbsize"] / (obj["fdim_us"] + obj["fold_us"]),
                "resp_sz": obj["resp_sz"], "item_sz": obj["item_sz"],
                "param_sz": obj.get("param_sz", 0),
                "params": obj["params"], "query_sz": obj["query_sz"],
                "other_data": obj}
    return obj


def run_system(system: str, db_items_log2: int, itemsize: int,
               streaming: bool = False, show_output: bool = False,
               cmd_extras: list[str] | None = None) -> dict:
    assert system in SYSTEMS, "Must choose available system."
    if streaming:
        assert itemsize == 1, "Must set itemsize to 1 for streaming."
    if system == "nopriv":
        # baseline: the server just sends the item (ref: run_scheme.py:184)
        return {"total_us": 0, "resp_sz": itemsize, "query_sz": 0}
    if "spiral" in system:
        return _run_spiral(system, db_items_log2, itemsize, streaming,
                           show_output, cmd_extras)
    return _run_competitor(system, db_items_log2, itemsize, streaming,
                           show_output)


def run_system_tr(system: str, db_items_log2: int, itemsize: int,
                  streaming: bool = False, show_output: bool = False,
                  cmd_extras: list[str] | None = None,
                  trials: int = 1) -> dict:
    """Trial-averaged run (ref: run_scheme.py:202-216)."""
    all_results = [run_system(system, db_items_log2, itemsize, streaming,
                              show_output, cmd_extras)
                   for _ in range(trials)]
    res = all_results[0]
    res["from_trials"] = trials
    keys = ["tput"] if streaming else ["total_us"]
    if "spiral" in system and not streaming:
        keys.append("cost")
    for key in keys:
        vals = [r[key] for r in all_results if key in r]
        if vals:
            res[key] = sum(vals) / len(vals)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one PIR system.")
    ap.add_argument("system", choices=SYSTEMS)
    ap.add_argument("targetnum", metavar="logN", type=int)
    ap.add_argument("itemsize", type=int)
    ap.add_argument("--show-output", action="store_true")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="the device Spiral's server runs on (default cuda)")
    args = ap.parse_args(argv)
    try:
        result = run_system_tr(args.system, args.targetnum, args.itemsize,
                               args.stream, args.show_output,
                               cmd_extras=["--device", args.device],
                               trials=args.trials)
    except SystemUnavailable as e:
        print(json.dumps({"error": str(e)}))
        return 2
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
