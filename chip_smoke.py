#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own line:
  1. the card: torch.cuda.is_available() (exit 1 without it) and
     nvidia-smi's name and power limit;
  2. build of the CUDA kernels from spiral_tpu_torch/csrc (one nvcc per
     source, in parallel): K1 ntt, K2 firstdim, K3 fold, K4 expand,
     K6 fold_pack, K7 pack;
  3. each kernel against its plain PyTorch version on the card, for bit
     equality, with both times and the kernel's bound: K1-K4 at the
     spiral_20_256 shapes; K1, K2, K4, K6 and K7 at the spiralpack_20_256
     shapes;
  4. Spiral: a tiny flow on the card against the plain CPU flow (equal
     response rows), then end to end at spiral_20_256: a seeded client, a
     2^20 x 256 B database from a numpy seed encoded on the card, and
     three queries (index 0, total_n - 1 and a random one), each decoded
     against its record, with every kernel's launch count over that run;
  5. SpiralPack, the same at tiny_pack and spiralpack_20_256 (2^20 x 256 B
     as 8,192 records of 4 x 4 polys), after the Spiral database is freed.
The line before last is the kernels' JSON, the last line
{"ok": true, "device": {...}}.  Any failure raises and exits nonzero.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

# The least time the card could take for a kernel's work is the larger of
# its bytes (each input read once, each output written once) over the
# memory rate and its u32 x u32 -> u64 modular products over the integer
# multiply rate.  H100 SXM: 3.35 TB/s of HBM3; 132 SMs x 64 32-bit integer
# multiply-adds per clock (half the 128 float32 lanes behind the 67 TFLOP/s
# float32 peak) x 1.98 GHz boost, one issue per product (the Barrett
# reductions and the CRT lifts are not counted).
HBM_BYTES_PER_S = 3.35e12
INT_PRODUCTS_PER_S = 132 * 64 * 1.98e9

# kernel -> (its CUDA source, the TPU kernel's function it replaces)
KERNEL_META = {
    "ntt":("spiral_tpu_torch/csrc/ntt.cu",
            "spiral_tpu/arith/ntt_pallas.py:396"),
    "firstdim": ("spiral_tpu_torch/csrc/firstdim.cu",
                 "spiral_tpu/server/firstdim.py:229"),
    "fold": ("spiral_tpu_torch/csrc/fold.cu",
             "spiral_tpu/server/fold_pallas.py:378"),
    "expand": ("spiral_tpu_torch/csrc/expand.cu",
               "spiral_tpu/server/expand_pallas.py:324"),
    "fold_pack": ("spiral_tpu_torch/csrc/fold.cu",
                  "spiral_tpu/server/fold_pallas.py:378"),
    "pack": ("spiral_tpu_torch/csrc/pack.cu",
             "spiral_tpu/server/pack_pallas.py:94"),
}
SPIRAL_PATH = ("ntt", "firstdim", "fold", "expand")
PACK_PATH = ("ntt", "firstdim", "expand", "fold_pack", "pack")


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
    from spiral_tpu_torch.params import B_I, P_I
    limbs = [torch.randint(0, p, shape, generator=gen, dtype=torch.int32,
                           device="cuda") for p in (P_I, B_I)]
    return torch.stack(limbs, dim=limb_axis)


def ntt_products(d: int) -> int:
    """Modular products of one length-d NTT: the (un)twist and the d/2
    butterflies of each of the log2(d) stages."""
    return d + d // 2 * (d.bit_length() - 1)


def fold_products(m_out: int, n1: int, n2: int, t: int, d: int) -> int:
    """K3 / K6 round: per (output ct, column, limb) 2*n1*t digit NTTs, each
    slot multiplied into n1 rows, and n1 inverse NTTs."""
    per = 2 * n1 * t * (ntt_products(d) + n1 * d) + n1 * ntt_products(d)
    return m_out * n2 * 2 * per


def check_kernels(seed: int) -> dict:
    """Phase 3: kernel vs plain version on the card, at the main paths'
    shapes.  Returns {kernel: {case: record}} for the JSON line; each
    kernel's first case is its main-path shape."""
    from spiral_tpu_torch.arith import ntt
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.server import expand, firstdim, fold, pack

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = preset("spiral_20_256")
    d, n1, n2 = params.poly_len, params.n1, params.n2
    K, m = params.dim0 * params.n0, params.num_per * n2
    cases = []
    # K1 at the first-dim output: num_per*n1*n2 polys
    x = rand_residues(gen, (params.num_per * n1 * n2, d))
    nttp = x.numel() // d * ntt_products(d)
    cases += [("ntt_forward", "ntt", lambda: ntt.forward(x),
               lambda: ntt.forward_plain(x), 20, [x], nttp),
              ("ntt_inverse", "ntt", lambda: ntt.inverse(x),
               lambda: ntt.inverse_plain(x), 20, [x], nttp)]
    # K2 on a database of the encoded shape (2 GiB)
    db = rand_residues(gen, (d, K, m), 0)
    qk = rand_residues(gen, (K, n1, d))
    cases.append(("firstdim", "firstdim",
                  lambda: firstdim.multiply_query_by_db(db, qk),
                  lambda: firstdim.multiply_plain(db, qk), 5, [db, qk],
                  2 * d * K * m * n1))
    # K3, first fold round, both digit widths
    cts = rand_residues(gen, (params.num_per, n1, n2, d))
    for name in ("spiral_20_256", "spiral_20_256_paper"):
        t = preset(name).t_gsw
        qn = rand_residues(gen, (n1, t * n1, d))
        qp = rand_residues(gen, (n1, t * n1, d))
        cases.append((f"fold_t{t}", "fold",
                      lambda qn=qn, qp=qp, t=t: fold.fold_round(cts, qn, qp, t),
                      lambda qn=qn, qp=qp, t=t: fold.fold_round_plain(
                          cts, qn, qp, t), 5, [cts, qn, qp],
                      fold_products(params.num_per // 2, n1, n2, t, d)))
    # K4, the largest rounds of each width
    k4_shapes = ((params.m_exp, 1 << (params.g - 1)),
                 (params.m_exp_right, 1 << params.stopround))
    for mk, N in k4_shapes:
        cv = rand_residues(gen, (N, 2, 1, d))
        ca = rand_residues(gen, (N, 2, 1, d))
        W = rand_residues(gen, (2, mk, d))
        prods = N * 2 * (mk * (ntt_products(d) + 2 * d) + ntt_products(d))
        cases.append((f"expand_m{mk}", "expand",
                      lambda cv=cv, ca=ca, W=W, mk=mk: expand.keyswitch(
                          cv, ca, W, mk),
                      lambda cv=cv, ca=ca, W=W, mk=mk: expand.keyswitch_plain(
                          cv, ca, W, mk), 5, [cv, ca, W], prods))
    # K6, the first pack fold round (16 trials x 128 cts -> 1,024 outputs),
    # both digit widths
    pp = preset("spiralpack_20_256")
    T = pp.out_n ** 2
    pcts = rand_residues(gen, (T, pp.num_per, 2, 1, d))
    for name in ("spiralpack_20_256", "spiralpack_20_256_paper"):
        t = preset(name).t_gsw
        qn = rand_residues(gen, (2, 2 * t, d))
        qp = rand_residues(gen, (2, 2 * t, d))
        cases.append((f"fold_pack_t{t}", "fold_pack",
                      lambda qn=qn, qp=qp, t=t: fold.fold_pack_round(
                          pcts, qn, qp, t),
                      lambda qn=qn, qp=qp, t=t: fold.fold_pack_round_plain(
                          pcts, qn, qp, t), 5, [pcts, qn, qp],
                      fold_products(T * pp.num_per // 2, 2, 1, t, d)))
    # K1 at the pack path's shapes: the first-dim output (T*num_per*2
    # polys) and the packed response ((out_n+1)*out_n polys)
    px = rand_residues(gen, (T * pp.num_per * 2, d))
    pout = rand_residues(gen, ((pp.out_n + 1) * pp.out_n, d))
    for tag, xx in (("pack", px), ("pack_out", pout)):
        prods = xx.numel() // d * ntt_products(d)
        cases += [(f"ntt_forward_{tag}", "ntt",
                   lambda xx=xx: ntt.forward(xx),
                   lambda xx=xx: ntt.forward_plain(xx), 20, [xx], prods),
                  (f"ntt_inverse_{tag}", "ntt",
                   lambda xx=xx: ntt.inverse(xx),
                   lambda xx=xx: ntt.inverse_plain(xx), 20, [xx], prods)]
    # K4 at the pack expansion's largest rounds (pack_g_stop's g and stop)
    # where they differ from the Spiral cases above
    from spiral_tpu_torch.pack import pack_g_stop
    g, stop = pack_g_stop(pp)
    for mk, N in sorted({(pp.m_exp, 1 << (g - 1)),
                         (pp.m_exp_right, 1 << stop)} - set(k4_shapes)):
        cv = rand_residues(gen, (N, 2, 1, d))
        ca = rand_residues(gen, (N, 2, 1, d))
        W = rand_residues(gen, (2, mk, d))
        prods = N * 2 * (mk * (ntt_products(d) + 2 * d) + ntt_products(d))
        cases.append((f"expand_m{mk}_pack", "expand",
                      lambda cv=cv, ca=ca, W=W, mk=mk: expand.keyswitch(
                          cv, ca, W, mk),
                      lambda cv=cv, ca=ca, W=W, mk=mk: expand.keyswitch_plain(
                          cv, ca, W, mk), 5, [cv, ca, W], prods))
    # K2 at the pack path's shape: n1 = 2 rows, K = dim0, m = T*num_per
    Kp, mp = pp.dim0, T * pp.num_per
    pdb = rand_residues(gen, (d, Kp, mp), 0)
    pqk = rand_residues(gen, (Kp, 2, d))
    cases.append(("firstdim_pack", "firstdim",
                  lambda: firstdim.multiply_query_by_db(pdb, pqk),
                  lambda: firstdim.multiply_plain(pdb, pqk), 5, [pdb, pqk],
                  2 * d * Kp * mp * 2))
    # K7, out_n 4, m_conv 4
    on, mc = pp.out_n, pp.m_conv
    rcts = rand_residues(gen, (T, 2, 1, d))
    v_W = rand_residues(gen, (on, on + 1, mc, d))
    cases.append((f"pack_n{on}_m{mc}", "pack",
                  lambda: pack.pack_ciphertexts(rcts, v_W),
                  lambda: pack.pack_ciphertexts_plain(rcts, v_W), 20,
                  [rcts, v_W],
                  on * 2 * on * (mc * (ntt_products(d) + (on + 1) * d) +
                                 ntt_products(d))))

    results = {}
    for name, kernel, run, plain, reps, inputs, prods in cases:
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        nbytes = sum(t.numel() * 4 for t in inputs) + got.numel() * 4
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = prods / INT_PRODUCTS_PER_S * 1e3
        rec = {"max_abs_err": err, "ms": cuda_ms(run, reps),
               "plain_ms": cuda_ms(plain, 1),
               "bound_ms": max(mem_ms, ops_ms),
               "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
               "bytes": nbytes, "products": prods,
               "shape": list(got.shape)}
        print(f"check {name}: max_abs_err={err} (tolerance 0) kernel "
              f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes} B, "
              f"{prods} products) out {tuple(got.shape)}", flush=True)
        if err:
            raise SystemExit(f"{name}: kernel differs from its plain version")
        results.setdefault(kernel, {})[name] = rec
    return results


def _variant(pack: bool):
    """(client class, server class, random db, encode db) of a variant."""
    from spiral_tpu_torch import pack as pk
    from spiral_tpu_torch import pir
    from spiral_tpu_torch.server import db
    if pack:
        return pk.PackClient, pk.PackServer, pk.random_pack_db, \
            pk.encode_pack_db
    return pir.SpiralClient, pir.SpiralServer, db.random_db, db.encode_db


def check_tiny(name: str, seed: int, pack: bool) -> None:
    """The whole flow at a tiny preset on the card equals the plain CPU
    flow, response row for response row."""
    from spiral_tpu_torch import interop
    from spiral_tpu_torch.params import preset

    p = preset(name)
    Client, Server, random_db, encode = _variant(pack)
    rows = []
    for dev in ("cpu", "cuda"):
        client = Client(p, seed=seed, device=dev)
        pts = random_db(p, np.random.default_rng(seed))
        server = Server(p, encode(pts, p, torch.device(dev)), client.setup())
        resp, _ = server.process_query(client.query(p.total_n - 1))
        if not np.array_equal(client.decode(resp),
                              pts[p.total_n - 1].astype(object)):
            raise SystemExit(f"{name} on {dev}: wrong record")
        rows.append(interop.response_rows(resp))
    same = all(np.array_equal(a, b) for a, b in zip(*rows))
    print(f"{name}: cuda response rows equal the plain cpu rows: {same}",
          flush=True)
    if not same:
        raise SystemExit(f"{name}: cuda and cpu responses differ")


def run_path(name: str, seed: int, card: str, pack: bool,
             path: tuple) -> tuple[dict, dict]:
    """End to end at a full-size preset on the card: a database from numpy
    seed `seed`, a seeded client and three queries, each decoded against
    its record.  Returns the launch counts over the run (database encode
    and client setup included), which must be nonzero for every kernel of
    `path`, and those of the last query alone."""
    from spiral_tpu_torch import kernels
    from spiral_tpu_torch.params import preset

    params = preset(name)
    Client, Server, random_db, encode = _variant(pack)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    pts = random_db(params, rng)
    t1 = time.perf_counter()
    kernels.reset_launches()
    db = encode(pts, params, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    client = Client(params, seed=seed, device=dev)
    pub = client.setup()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    server = Server(params, db, pub)
    print(f"{name} setup: db gen {t1 - t0:.2f} s, encode on card "
          f"{t2 - t1:.2f} s, client keys+public params {t3 - t2:.2f} s",
          flush=True)

    idxs = [0, params.total_n - 1, int(rng.integers(0, params.total_n))]
    db_bytes = pts.size * int(np.log2(params.p_db)) // 8
    for idx in idxs:
        q = client.query(idx)
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        w0 = time.perf_counter()
        resp, tm = server.process_query(q)
        wall = time.perf_counter() - w0
        per_query = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        ok = np.array_equal(client.decode(resp), pts[idx].astype(object))
        stages = {k: round(v, 1) for k, v in vars(tm).items()}
        print(f"{name} query idx={idx} correct={ok} server "
              f"{tm.total_us / 1e3:.3f} ms (cuda events; host wall "
              f"{wall * 1e3:.1f} ms) "
              f"{db_bytes / tm.total_us:.1f} MB/s stages_us={stages} "
              f"launches={per_query} [{card}]", flush=True)
        if not ok:
            raise SystemExit(f"{name} query {idx} decoded to the wrong "
                             f"record")
    launches = dict(kernels.LAUNCHES)
    print(f"{name} launches over the path: {launches}", flush=True)
    if not all(launches[k] for k in path):
        raise SystemExit(f"{name}: a kernel of the path was never launched")
    fd_ms = tm.first_multiply_us / 1e3
    print(f"{name} first-dim stage streams {db.data.numel() * 4 / 2**30:.2f} "
          f"GiB of encoded db in {fd_ms:.3f} ms (incl. inverse NTT): "
          f"{db.data.numel() * 4 / fd_ms / 1e9:.3f} TB/s of 3.35", flush=True)
    return launches, per_query


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spiral_tpu_torch import kernels

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    kernels.lib(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, "
          f"{len(kernels.SOURCES)} sources in parallel and the link: "
          f"{kernels.build_seconds:.2f} s)", flush=True)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    checks = check_kernels(args.seed)
    torch.cuda.empty_cache()
    check_tiny("tiny", args.seed, pack=False)
    spiral, spiral_q = run_path("spiral_20_256", args.seed, card, False,
                                SPIRAL_PATH)
    gc.collect()
    torch.cuda.empty_cache()      # the Spiral database is freed here
    check_tiny("tiny_pack", args.seed, pack=True)
    packed, packed_q = run_path("spiralpack_20_256", args.seed, card, True,
                                PACK_PATH)

    out = []
    for kernel, (src, repl) in KERNEL_META.items():
        recs = checks[kernel]
        main_case = next(iter(recs.values()))
        out.append({
            "name": kernel, "route": "cuda", "source": src, "replaces": repl,
            # the launches of the two driven runs (each counted from 0);
            # launches_by_path and launches_per_query split it
            "launches": spiral[kernel] + packed[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "launches_by_path": {"spiral_20_256": spiral[kernel],
                                 "spiralpack_20_256": packed[kernel]},
            "launches_per_query": {"spiral_20_256": spiral_q[kernel],
                                   "spiralpack_20_256": packed_q[kernel]},
            "cases": recs})
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
