"""CLI mirroring the reference's select_params.py contract (the port's
counterpart of spiral_tpu/select_params.py):

    python -m spiral_tpu_torch.select_params <logN> <itemsize_bytes>
        [--direct-upload] [--pack] [--max-query-size B] [--dry-run]
        [--trials N] [--explicit-db] [--device cuda|cpu]

Picks parameters via the noise model, the LUT measured on the card and
the cost proxy fitted to it (paramgen/search.py), optionally runs the
scheme end to end on the card (--device cpu: on the CPU), and emits ONE
JSON line with the same metric names the reference's harness scrapes
(ref: select_params.py:566-587).  A wrong decode prints "is_corr": false.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("logN", type=int)
    ap.add_argument("itemsize", type=int)
    ap.add_argument("--direct-upload", action="store_true")
    ap.add_argument("--pack", "--high-rate", action="store_true",
                    dest="pack")
    ap.add_argument("--max-query-size", type=int, default=None)
    ap.add_argument("--max-param-size", type=int, default=None)
    ap.add_argument("--max-total-query-size", type=int, default=None)
    ap.add_argument("--optimize-for", default="",
                    choices=("", "rate", "tput"))
    ap.add_argument("--dry-run", action="store_true",
                    help="select parameters only; do not run")
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--explicit-db", action="store_true",
                    help="(compat flag; databases are always explicit here)")
    ap.add_argument("--poly-len", type=int, default=2048)
    ap.add_argument("--set-dims", nargs=2, type=int, metavar=("NU1", "NU2"),
                    default=None,
                    help="pin nu_1/nu_2 instead of searching them "
                         "(ref: select_params.py --set-dims)")
    ap.add_argument("--build-exp-lut", action="store_true",
                    help="after selection, measure the chosen config on "
                         "the card (with per-stage breakdown) and record "
                         "it in the H100 LUT (ref: select_params.py "
                         "--build-exp-lut)")
    ap.add_argument("--build-fdim-lut", action="store_true",
                    help="alias of --build-exp-lut: the LUT records every "
                         "stage of one measured run (the reference needed "
                         "two separate builds, select_params.py:451-518)")
    ap.add_argument("--device", default="cuda",
                    help="the device the server runs on (default cuda)")
    args = ap.parse_args(argv)

    from .paramgen.search import _record_bytes, _response_bytes, select_params
    sel = select_params(args.logN, args.itemsize,
                        direct_upload=args.direct_upload, pack=args.pack,
                        max_query_bytes=args.max_query_size,
                        max_param_bytes=args.max_param_size,
                        max_total_query_bytes=args.max_total_query_size,
                        optimize_for=args.optimize_for,
                        d=args.poly_len,
                        set_dims=tuple(args.set_dims)
                        if args.set_dims else None)
    p = sel.params
    item_b = _record_bytes(p, args.pack)
    resp_b = _response_bytes(p, args.pack)

    out = {
        "params": dataclasses.asdict(p),
        "factor": sel.factor,
        "p_err_bits": round(sel.p_err_bits, 2),
        "query_sz": p.query_size_bytes(),
        "resp_sz": resp_b,
        "item_sz": item_b,
        "rate": round(item_b / resp_b, 4),
        "param_sz": p.public_param_size_bytes(),
        "dbsize": (1 << args.logN) * args.itemsize,
    }
    if not args.dry_run:
        out.update(_run(p, sel.factor, args))
    if args.build_exp_lut or args.build_fdim_lut:
        import pathlib

        from .paramgen import build_lut
        lut = dict(build_lut.load_lut())
        lut[build_lut.lut_key(p)] = build_lut.measure(
            p, args.pack, trials=max(2, args.trials), stages=True,
            device=args.device)
        pathlib.Path(build_lut.DEFAULT_LUT).write_text(
            json.dumps(lut, indent=1))
        build_lut._LUT_CACHE[str(build_lut.DEFAULT_LUT)] = lut
        out["lut_entry"] = build_lut.lut_key(p)
    print(json.dumps(out), flush=True)
    return 0


def _run(p, factor: int, args) -> dict:
    """Serve one query `args.trials` times on `args.device` over a database
    drawn from numpy seed 0: a PackServer, a FactoredSpiralServer when
    factor > 1, else a SpiralServer.  -> the decode check and the best
    trial's ServerTimings, under the reference's keys."""
    import numpy as np
    import torch
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    dt = np.int16 if p.p_db <= (1 << 15) else np.int32
    if args.pack:
        from .pack import PackClient, PackServer, encode_pack_db
        client = PackClient(p, seed=1, device=device)
        pub = client.setup()
        pts = rng.integers(0, p.p_db, size=(
            p.total_n, p.out_n, p.out_n, p.poly_len), dtype=dt)
        server = PackServer(p, encode_pack_db(pts, p, device), pub)
    elif factor > 1:
        # oversized items: the factored pipeline (all factor
        # sub-databases streamed by one first-dimension pass; ref:
        # select_params.py:291-303 semantics, but measured)
        from .factored import FactoredSpiralServer, encode_factored_db
        from .pir import SpiralClient
        client = SpiralClient(p, seed=1, device=device)
        pub = client.setup()
        pts = rng.integers(0, p.p_db, size=(
            p.total_n, factor, p.n0, p.n2, p.poly_len), dtype=dt)
        server = FactoredSpiralServer(p, encode_factored_db(pts, p, device),
                                      pub)
    else:
        from .pir import SpiralClient, SpiralServer
        from .server.db import encode_db
        client = SpiralClient(p, seed=1, device=device)
        pub = client.setup()
        pts = rng.integers(0, p.p_db, size=(
            p.total_n, p.n0, p.n2, p.poly_len), dtype=dt)
        server = SpiralServer(p, encode_db(pts, p, device), pub)
    idx = int(rng.integers(0, p.total_n))
    query = client.query(idx)
    want = pts[idx].astype(object)
    totals = []
    correct = True
    for _ in range(args.trials):
        resp, timings = server.process_query(query)
        totals.append(timings)
        if factor > 1 and not args.pack:
            from .factored import decode_factored
            res = decode_factored(client, resp)
        else:
            res = client.decode(resp)
        correct = correct and bool(np.array_equal(res, want))
    best = min(totals, key=lambda x: x.total_us)
    return {
        "is_corr": correct,
        "total_us": round(best.total_us),
        "exp_us": round(best.expansion_us),
        "conv_us": round(best.composition_us + best.conversion_us),
        "fdim_us": round(best.first_multiply_us),
        "fold_us": round(best.folding_us),
        "pack_us": round(best.packing_us),
        "tput_mb_s": round(
            (1 << args.logN) * args.itemsize / best.total_us, 2),
    }


if __name__ == "__main__":
    sys.exit(main())
