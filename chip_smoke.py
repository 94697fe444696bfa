#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own line:
  1. the card: torch.cuda.is_available() (exit 1 without it) and
     nvidia-smi's name and power limit;
  2. build of the CUDA kernels K1-K4 from spiral_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the card, at the
     spiral_20_256 shapes, for bit equality, with both times;
  4. a tiny flow on the card against the plain CPU flow (equal response
     rows), then end to end at spiral_20_256: a seeded client, a 2^20 x
     256 B database from a numpy seed encoded on the card, and three
     queries (index 0, total_n - 1 and a random one), each decoded
     against its record, with every kernel's launch count over that run.
The line before last is the kernels' JSON, the last line
{"ok": true, "device": {...}}.  Any failure raises and exits nonzero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches, CUDA events, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rand_residues(gen, shape, limb_axis: int = -2):
    """Uniform residues made on the card: `shape` with the (P_I, B_I) limb
    axis inserted at limb_axis."""
    from spiral_tpu.params import B_I, P_I
    limbs = [torch.randint(0, p, shape, generator=gen, dtype=torch.int32,
                           device="cuda") for p in (P_I, B_I)]
    return torch.stack(limbs, dim=limb_axis)


def check_kernels(params, seed: int) -> dict:
    """Phase 3: kernel vs plain version on the card, at the main path's
    shapes.  Returns {kernel: {case: record}} for the JSON line."""
    from spiral_tpu.params import preset
    from spiral_tpu_torch.arith import ntt
    from spiral_tpu_torch.server import expand, firstdim, fold
    from spiral_tpu_torch.server.db import EncodedDb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, n1, n2 = params.poly_len, params.n1, params.n2
    K = params.dim0 * params.n0
    db = EncodedDb(rand_residues(gen, (d, K, params.num_per * n2), 0),
                   params)
    cases = []
    # K1 at the first-dim output: num_per*n1*n2 polys
    x = rand_residues(gen, (params.num_per * n1 * n2, d))
    cases += [("ntt_forward", "ntt", lambda: ntt.forward(x),
               lambda: ntt.forward_plain(x), 20),
              ("ntt_inverse", "ntt", lambda: ntt.inverse(x),
               lambda: ntt.inverse_plain(x), 20)]
    # K2 on a database of the encoded shape (2 GiB)
    qk = rand_residues(gen, (K, n1, d))
    cases.append(("firstdim", "firstdim",
                  lambda: firstdim.multiply_query_by_db(db.data, qk),
                  lambda: firstdim.multiply_plain(db.data, qk), 5))
    # K3, first fold round, both digit widths
    cts = rand_residues(gen, (params.num_per, n1, n2, d))
    for name in ("spiral_20_256", "spiral_20_256_paper"):
        t = preset(name).t_gsw
        qn = rand_residues(gen, (n1, t * n1, d))
        qp = rand_residues(gen, (n1, t * n1, d))
        cases.append((f"fold_t{t}", "fold",
                      lambda qn=qn, qp=qp, t=t: fold.fold_round(cts, qn, qp, t),
                      lambda qn=qn, qp=qp, t=t: fold.fold_round_plain(
                          cts, qn, qp, t), 5))
    # K4, the largest rounds of each width
    for m, N in ((params.m_exp, 1 << (params.g - 1)),
                 (params.m_exp_right, 1 << params.stopround)):
        cv = rand_residues(gen, (N, 2, 1, d))
        ca = rand_residues(gen, (N, 2, 1, d))
        W = rand_residues(gen, (2, m, d))
        cases.append((f"expand_m{m}", "expand",
                      lambda cv=cv, ca=ca, W=W, m=m: expand.keyswitch(
                          cv, ca, W, m),
                      lambda cv=cv, ca=ca, W=W, m=m: expand.keyswitch_plain(
                          cv, ca, W, m), 5))

    results = {}
    for name, kernel, run, plain, reps in cases:
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        rec = {"max_abs_err": err, "ms": cuda_ms(run, reps),
               "plain_ms": cuda_ms(plain, 1), "shape": list(got.shape)}
        print(f"check {name}: max_abs_err={err} (tolerance 0) kernel "
              f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms out "
              f"{tuple(got.shape)}", flush=True)
        if err:
            raise SystemExit(f"{name}: kernel differs from its plain version")
        results.setdefault(kernel, {})[name] = rec
    return results


def check_tiny(seed: int) -> None:
    """Phase 4a: the whole flow at `tiny` on the card equals the plain CPU
    flow, response row for response row."""
    from spiral_tpu.params import preset
    from spiral_tpu_torch import interop
    from spiral_tpu_torch.pir import SpiralClient, SpiralServer
    from spiral_tpu_torch.server.db import encode_db, random_db

    p = preset("tiny")
    rows = []
    for dev in ("cpu", "cuda"):
        client = SpiralClient(p, seed=seed, device=dev)
        pts = random_db(p, np.random.default_rng(seed))
        server = SpiralServer(p, encode_db(pts, p, torch.device(dev)),
                              client.setup())
        resp, _ = server.process_query(client.query(p.total_n - 1))
        if not np.array_equal(client.decode(resp),
                              pts[p.total_n - 1].astype(object)):
            raise SystemExit(f"tiny on {dev}: wrong record")
        rows.append(interop.response_rows(resp))
    same = all(np.array_equal(a, b) for a, b in zip(*rows))
    print(f"tiny: cuda response rows equal the plain cpu rows: {same}",
          flush=True)
    if not same:
        raise SystemExit("tiny: cuda and cpu responses differ")


def run_main_path(params, seed: int, card: str) -> dict:
    """Phase 4b: spiral_20_256 end to end.  Returns the launch counts."""
    from spiral_tpu_torch import kernels
    from spiral_tpu_torch.pir import SpiralClient, SpiralServer
    from spiral_tpu_torch.server.db import encode_db, random_db

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    pts = random_db(params, rng)
    t1 = time.perf_counter()
    kernels.reset_launches()
    db = encode_db(pts, params, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    client = SpiralClient(params, seed=seed, device=dev)
    pub = client.setup()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    server = SpiralServer(params, db, pub)
    print(f"setup: db gen {t1 - t0:.2f} s, encode on card {t2 - t1:.2f} s, "
          f"client keys+public params {t3 - t2:.2f} s", flush=True)

    idxs = [0, params.total_n - 1, int(rng.integers(0, params.total_n))]
    db_bytes = params.total_n * params.n0 * params.n2 * params.poly_len * \
        int(np.log2(params.p_db)) // 8
    for idx in idxs:
        q = client.query(idx)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        resp, tm = server.process_query(q)
        wall = time.perf_counter() - w0
        ok = np.array_equal(client.decode(resp), pts[idx].astype(object))
        stages = {k: round(v, 1) for k, v in vars(tm).items()}
        print(f"query idx={idx} correct={ok} server "
              f"{tm.total_us / 1e3:.3f} ms (cuda events; host wall "
              f"{wall * 1e3:.1f} ms) "
              f"{db_bytes / tm.total_us:.1f} MB/s stages_us={stages} "
              f"[{card}]", flush=True)
        if not ok:
            raise SystemExit(f"query {idx} decoded to the wrong record")
    launches = dict(kernels.LAUNCHES)
    print(f"launches over the main path: {launches}", flush=True)
    if not all(launches.values()):
        raise SystemExit("a kernel of the path was never launched")
    fd_ms = tm.first_multiply_us / 1e3
    print(f"first-dim stage streams {db.data.numel() * 4 / 2**30:.2f} GiB of "
          f"encoded db in {fd_ms:.3f} ms (incl. inverse NTT): "
          f"{db.data.numel() * 4 / fd_ms / 1e9:.3f} TB/s of 3.35", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spiral_tpu.params import preset
    from spiral_tpu_torch import kernels

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    kernels.lib(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{kernels.build_seconds:.2f} s)", flush=True)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    params = preset("spiral_20_256")
    checks = check_kernels(params, args.seed)
    torch.cuda.empty_cache()
    check_tiny(args.seed)
    launches = run_main_path(params, args.seed, card)

    meta = {
        "ntt": ("spiral_tpu_torch/csrc/ntt.cu",
                "spiral_tpu/arith/ntt_pallas.py:396"),
        "firstdim": ("spiral_tpu_torch/csrc/firstdim.cu",
                     "spiral_tpu/server/firstdim.py:229"),
        "fold": ("spiral_tpu_torch/csrc/fold.cu",
                 "spiral_tpu/server/fold_pallas.py:378"),
        "expand": ("spiral_tpu_torch/csrc/expand.cu",
                   "spiral_tpu/server/expand_pallas.py:324"),
    }
    out = []
    for kernel, (src, repl) in meta.items():
        recs = checks[kernel]
        out.append({
            "name": kernel, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "ms": sum(r["ms"] for r in recs.values()),
            "plain_ms": sum(r["plain_ms"] for r in recs.values()),
            "cases": recs})
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
