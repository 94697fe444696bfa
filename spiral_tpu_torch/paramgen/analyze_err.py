"""Empirical noise analysis of the port (counterpart of
spiral_tpu/paramgen/analyze_err.py; ref: analyze_err.py + util.cpp
get_log_var).

Collects signed decode-error samples from end-to-end runs, reports the
empirical log2 variance, and extrapolates the decode-failure rate under a
hypothetical modulus via the subgaussian tail — the tooling used to
validate the analytical 2^-40 model against reality.
"""
from __future__ import annotations

import math

import numpy as np

from ..params import Params, Q
from .noise import p_err_bits


def error_samples(final_ct_host: np.ndarray, S_centered_rows, pt_expected,
                  params: Params) -> np.ndarray:
    """Signed error e = S*ct - Delta*pt over R_Q (pre-modswitch), flattened.

    final_ct_host: (n1, n2, d) ints mod Q.  S_centered_rows: the secret
    S = [Sp | I] rows as centered int arrays (n0, n1, d) with small Sp.
    pt_expected: (n0, n2, d) ints mod p.
    """
    n0, n2, d = pt_expected.shape
    delta = params.scale_k
    p_db = params.p_db
    errs = []
    for r in range(n0):
        for c in range(n2):
            acc = np.zeros(d, dtype=object)
            for m in range(S_centered_rows.shape[1]):
                s_poly = S_centered_rows[r, m]
                b_poly = np.asarray(final_ct_host[m, c], dtype=object)
                full = np.convolve(s_poly.astype(object), b_poly)
                res = full[:d].copy()
                res[:d - 1] -= full[d:]
                acc = (acc + res) % Q
            pt = pt_expected[r, c].astype(object)
            ptc = np.where(pt >= p_db // 2, pt - p_db, pt)
            diff = (acc - delta * ptc) % Q
            diff = np.where(diff >= Q // 2, diff - Q, diff)
            errs.append(diff)
    return np.concatenate(errs)


def log2_variance(errs: np.ndarray) -> float:
    v = np.var(errs.astype(np.float64))
    return math.log2(v) if v > 0 else 0.0


def empirical_subgaussian_width(errs: np.ndarray) -> float:
    """sqrt(variance) interpreted as the subgaussian parameter."""
    return float(np.sqrt(np.var(errs.astype(np.float64))))


def extrapolate_p_err(errs: np.ndarray, params: Params) -> float:
    """log2 failure probability at the configured q' from measured width
    (the analyze_err.py extrapolation)."""
    s_e = float(np.var(errs.astype(np.float64)))
    return p_err_bits(params.p_db, params.arb_qprime, s_e,
                      n=params.n0, d=params.poly_len)


def modulus_cutoff(errs, bins, p) -> list[float]:
    """Empirical decode-failure rate per hypothetical modulus: an error e
    decodes wrong under modulus q when |e| * (p/q) > 1/2 (ref:
    analyze_err.py:6-14, vectorized)."""
    e = np.abs(np.asarray(errs, dtype=np.float64))
    return [float(np.mean(e * (p / q) > 0.5)) for q in bins]


def extend_subg(error_rate: float, modulus: float, p: int) -> float:
    """Subgaussian width (log2 of s_e^2) that reproduces `error_rate` at
    `modulus` — the extrapolation anchor (ref: analyze_err.py:16-23)."""
    logq = math.log(modulus, 2)
    logp = math.log(p, 2)
    logpi = math.log(math.pi, 2)
    return (2 * (logq - (logp + 1)) + logpi -
            math.log(math.log(2) - math.log(error_rate), 2))


def rate_table(errs, p: int, min_observations: int = 5):
    """(bins, rates) after dropping the near-zero tail (fewer than
    `min_observations` failing samples — ref: analyze_err.py:30-39)."""
    bins = [2 ** i for i in np.arange(40, 60, 0.1)]
    rates = modulus_cutoff(errs, bins, p)
    num_zeros = 0
    for r in reversed(rates):
        if r > min_observations / len(errs):
            break
        num_zeros += 1
    if num_zeros:
        rates = rates[:-num_zeros]
    return bins[:len(rates)], rates


def collect_errors(preset_name: str, seeds: int = 1,
                   device="cuda") -> np.ndarray:
    """Run `seeds` end-to-end queries on a preset on `device` and return
    the pooled signed pre-modswitch error samples (the final_ciphertext
    hook — the CLI-level stand-in for the reference's --output-err dump).
    final_ciphertext's (n1, n2, 2, d) CRT limbs are lifted mod Q."""
    from ..arith.crt import lift_pair
    from ..params import preset as _preset
    from ..pir import SpiralClient, SpiralServer
    from ..server.db import encode_db, random_db
    params = _preset(preset_name)
    all_errs = []
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        client = SpiralClient(params, seed=seed, device=device)
        pub = client.setup()
        pts = random_db(params, rng)
        server = SpiralServer(params, encode_db(pts, params, device), pub)
        idx = int(rng.integers(0, params.total_n))
        query = client.query(idx)
        final = server.final_ciphertext(query)
        final_host = lift_pair(final[..., 0, :], final[..., 1, :]) \
            .cpu().numpy()
        S_centered = np.concatenate(
            [client.keys.Sp_centered,
             np.eye(params.n0, dtype=np.int64)[:, :, None] *
             np.array([1] + [0] * (params.poly_len - 1))], axis=1)
        all_errs.append(
            error_samples(final_host, S_centered, pts[idx], params))
    return np.concatenate(all_errs)


def main(argv=None) -> int:
    """CLI parity with the reference's analyze_err.py: print the
    rate-vs-modulus table and the extrapolated subgaussian width.

    File mode (reference-compatible):
        python -m spiral_tpu_torch.paramgen.analyze_err <p> <err_dump_file>
    Collect mode (no dump file needed — runs a preset end-to-end on the
    card, or on --device):
        python -m spiral_tpu_torch.paramgen.analyze_err --collect tiny \
            [--seeds N] [--dump errs.txt] [--device cuda|cpu]
    """
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("p", nargs="?", type=int,
                    help="plaintext modulus (file mode)")
    ap.add_argument("errfile", nargs="?",
                    help="space-separated signed error dump (file mode)")
    ap.add_argument("--collect", metavar="PRESET",
                    help="run PRESET end-to-end and analyze its errors")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--dump", help="also write collected errors to FILE")
    ap.add_argument("--device", default="cuda",
                    help="the device the collect run's server runs on "
                         "(default cuda)")
    args = ap.parse_args(argv)

    if args.collect:
        from ..params import preset as _preset
        params = _preset(args.collect)
        p = params.p_db
        errs = collect_errors(args.collect, args.seeds, args.device)
        if args.dump:
            with open(args.dump, "w") as f:
                f.write(" ".join(str(int(e)) for e in errs))
    else:
        if args.p is None or args.errfile is None:
            print("usage: analyze_err <p> <errfile> | --collect PRESET")
            return 2
        p = args.p
        with open(args.errfile) as f:
            errs = np.array([int(i) for i in f.read().strip().split()],
                            dtype=object)
    print(len(errs))
    bins, rates = rate_table(errs, p)
    print(f"{'modulus':>8}  err_rate")
    for q, r in zip(bins, rates):
        print(f"{math.log(q, 2):8.3f}  {r}")
    if not rates:
        print("no failing samples in the binned range")
        return 0
    last_err, last_mod = rates[-1], bins[-1]
    print(last_err, last_mod)
    print("Extended subg. width:", extend_subg(last_err, last_mod, p))
    print("log2(empirical variance):", round(log2_variance(
        np.asarray(errs, dtype=np.float64)), 2))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
