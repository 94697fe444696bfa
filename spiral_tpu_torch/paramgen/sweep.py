"""Offline parameter-space sweep -> committed artifact (the port's
counterpart of spiral_tpu/paramgen/sweep.py, with its own artifact; ref:
generate_all_schemes.py:308-477 perform_search + all_params*.pkl).

Enumerates the reference's full search spaces (regular / streaming /
highrate / highrate-streaming — p up to 2^20, dense t_GSW 2..56,
out_n in {2,4,8,12}), runs the 2^-40 noise/correctness model on every
candidate with multiprocessing, Pareto-prunes along the gadget widths
(a candidate dominated in (t_gsw, t_conv, t_exp, q'_bits) can never win
any ranking: cost is monotone increasing and noise monotone decreasing
in each width), and writes the survivors as compact numpy arrays.

    python -m spiral_tpu_torch.paramgen.sweep [--procs N]

writes spiral_tpu_torch/paramgen/all_params.npz (pure Python and numpy:
it runs on the CPU).  `search.select_params` loads the artifact (<1s
warm) instead of re-running the model per CLI invocation.
"""
from __future__ import annotations

import argparse
import itertools
import multiprocessing
import pathlib
import sys
import time

import numpy as np

from ..params import QPRIME_MODS, Params
from .noise import (min_qprime_bits, noise_variance, noise_variance_highrate,
                    p_err_bits)

DEFAULT_OUT = pathlib.Path(__file__).parent / "all_params.npz"

# variant ids
REGULAR, STREAMING, HIGHRATE, HIGHRATE_STREAMING = 0, 1, 2, 3

T_CHOICES = (2, 4, 8, 16, 32, 56)


def _spaces():
    """Mirror of the reference's get_*_choices search spaces
    (generate_all_schemes.py:308-422)."""
    def nus(j1_hi, j2_hi):
        return [(j1, j2) for j1 in range(2, j1_hi + 1)
                for j2 in range(2, j2_hi + 1) if j1 + j2 >= 10]

    return {
        REGULAR: dict(p_logs=range(2, 16), nus=nus(10, 13),
                      t_gsw=range(2, 57), t_conv=T_CHOICES,
                      t_exp=T_CHOICES, out_n=(2,)),
        STREAMING: dict(p_logs=range(2, 21), nus=nus(13, 13),
                        t_gsw=range(2, 57), t_conv=T_CHOICES,
                        t_exp=(8,), out_n=(2,)),
        HIGHRATE: dict(p_logs=range(2, 21), nus=nus(10, 13),
                       t_gsw=range(2, 57), t_conv=T_CHOICES,
                       t_exp=T_CHOICES, out_n=(2, 4, 8, 12)),
        HIGHRATE_STREAMING: dict(p_logs=range(10, 31), nus=nus(13, 13),
                                 t_gsw=range(2, 11), t_conv=(56,),
                                 t_exp=(56,), out_n=(4, 5, 6, 7, 8, 9,
                                                     10, 11, 12)),
    }


def _eval_group(job):
    """One (variant, p_log, nu_1, nu_2, out_n) group: run the noise model
    over all gadget-width combos, keep the Pareto front over
    (t_gsw, t_conv, t_exp, qp_bits) minimization."""
    variant, p_log, nu_1, nu_2, out_n, t_gsws, t_convs, t_exps = job

    pack = variant in (HIGHRATE, HIGHRATE_STREAMING)
    direct = variant in (STREAMING, HIGHRATE_STREAMING)
    p_db = 1 << p_log
    rows = []
    for t_gsw, t_conv, t_exp in itertools.product(t_gsws, t_convs, t_exps):
        qe_first = (1 << nu_1) if direct else 1
        qe_rest = nu_2 * t_gsw if direct else 0
        try:
            base = Params(nu_1=nu_1, nu_2=nu_2, p_db=p_db, q_prime_bits=20,
                          t_gsw=t_gsw, t_conv=t_conv, t_exp=t_exp,
                          t_exp_right=56, out_n=out_n,
                          query_elems_first=qe_first, query_elems_rest=qe_rest)
            s_e = noise_variance_highrate(base) if pack else \
                noise_variance(base)
            n = out_n if pack else base.n0
            bits = min_qprime_bits(base, s_e, n=n)
            if bits is None:
                continue
            pe = p_err_bits(p_db, QPRIME_MODS[bits], s_e, n=n,
                            d=base.poly_len)
        except (AssertionError, ValueError, OverflowError, KeyError):
            continue
        rows.append((t_gsw, t_conv, t_exp, bits, pe))

    # Pareto prune: minimize (t_gsw, t_conv, t_exp, qp_bits) jointly
    rows.sort()
    kept = []
    for r in rows:
        dominated = any(
            k[0] <= r[0] and k[1] <= r[1] and k[2] <= r[2] and k[3] <= r[3]
            and k[:4] != r[:4] for k in kept)
        if not dominated:
            kept.append(r)
    return [(variant, p_log, nu_1, nu_2, out_n) + r for r in kept]


def run_sweep(out_path=DEFAULT_OUT, procs: int | None = None) -> dict:
    jobs = []
    for variant, sp in _spaces().items():
        for p_log in sp["p_logs"]:
            for (nu_1, nu_2) in sp["nus"]:
                for out_n in sp["out_n"]:
                    jobs.append((variant, p_log, nu_1, nu_2, out_n,
                                 tuple(sp["t_gsw"]), tuple(sp["t_conv"]),
                                 tuple(sp["t_exp"])))
    t0 = time.time()
    procs = procs or multiprocessing.cpu_count()
    if procs > 1:
        with multiprocessing.get_context("spawn").Pool(procs) as pool:
            results = pool.map(_eval_group, jobs, chunksize=16)
    else:
        results = [_eval_group(j) for j in jobs]
    rows = [r for group in results for r in group]
    arr = np.array([r[:9] for r in rows], dtype=np.int16)
    pe = np.array([r[9] for r in rows], dtype=np.float32)
    np.savez_compressed(
        out_path, variant=arr[:, 0].astype(np.int8),
        p_log=arr[:, 1].astype(np.int8), nu_1=arr[:, 2].astype(np.int8),
        nu_2=arr[:, 3].astype(np.int8), out_n=arr[:, 4].astype(np.int8),
        t_gsw=arr[:, 5].astype(np.int8), t_conv=arr[:, 6].astype(np.int8),
        t_exp=arr[:, 7].astype(np.int8), qp_bits=arr[:, 8].astype(np.int8),
        p_err_bits=pe)
    return {"rows": len(rows), "groups": len(jobs),
            "seconds": round(time.time() - t0, 1),
            "out": str(out_path)}


_ARTIFACT_CACHE: dict = {}


def load_artifact(path=DEFAULT_OUT):
    """dict of column arrays, or None if the artifact is absent."""
    key = str(path)
    if key not in _ARTIFACT_CACHE:
        p = pathlib.Path(path)
        if not p.exists():
            _ARTIFACT_CACHE[key] = None
        else:
            z = np.load(p)
            _ARTIFACT_CACHE[key] = {k: z[k] for k in z.files}
    return _ARTIFACT_CACHE[key]


def main(argv=None) -> int:
    import json
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--procs", type=int, default=None)
    args = ap.parse_args(argv)
    info = run_sweep(args.out, args.procs)
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    sys.exit(main())
