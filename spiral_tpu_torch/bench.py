"""Benchmark of the port (counterpart of the top-level bench.py): runs the
server pipeline and prints one JSON line {"metric", "value", "unit",
"vs_baseline", "detail"} with bench.py's keys and two more,
detail.stage_basis and detail.serving.

    python -m spiral_tpu_torch.bench [--preset spiral_20_256] [--trials 3]
        [--batch B] [--implicit] [--slab-bytes N] [--nonoise] [--verbose]
        [--device cuda|cpu]

The definitions are bench.py's.  The headline is min(pipelined_s, best
process_query_fused seconds): pipelined_s runs K = 8 distinct queries'
_run_single back to back and fetches every response once at the end;
host_rtt_floor_s is a trivial op on the device read back with .item();
batch8_* come from process_query_batch (not under --implicit); the stage
fields are profiling.device_stage_times for a packed Spiral query and
process_query's ServerTimings otherwise.  Throughput is plaintext
database bytes over the headline seconds, vs_baseline its ratio to the
reference's 165.7 MB/s.

detail.stage_basis names the stage fields' basis: "cuda_graph_events"
(device_stage_times on the card: the served graph's own stage events),
"cuda_graph_stages" (process_query on the card: CUDA events between the
replays of its per-stage graphs) or "host_clock" (a CPU run).  A direct (stream) query's
reconstruction is timed in expansion_us, where bench.py's JAX server
counts it in composition_us; stage_basis says so for such a query.
detail.serving names how the served, pipelined and batch times were
served (the server's ``serving``): "cuda_graph" (one CUDA-graph replay a
query or batch) or "eager" (a CPU run).

--verbose logs each step on stderr, and traces the database encode:
its spiral.encode spans and tracing.COUNTS["encoded_bytes"] in the log.

Runs on the card unless --device cpu.  Exits 1 when a decode is wrong.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

BASELINE_THROUGHPUT_MBPS = 165.7
PIPELINED_QUERIES = 8
BATCH = 8


def pt_dtype(params):
    """Smallest int dtype that holds plaintext values in [0, p_db)."""
    return np.int16 if params.p_db <= (1 << 15) else np.int32


def db_bytes(params, pack: bool) -> int:
    """Plaintext database bytes: total_n records of out_n^2 (pack) or
    n0*n2 polys of d coefficients of log2(p_db) bits."""
    pt_polys = params.out_n ** 2 if pack else params.n0 * params.n2
    return params.total_n * pt_polys * params.poly_len * \
        int(math.log2(params.p_db)) // 8


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(args, device: torch.device, log):
    """(params, pack, client, server, pts, rng): a seeded client and a
    server over a database drawn from numpy seed 0 (pts None for an
    implicit one), as bench.py builds them."""
    from . import tracing
    from .params import preset
    from .pack import PackClient, PackServer, encode_pack_db
    from .pir import SpiralClient, SpiralServer
    from .server.db import (encode_db, random_implicit_db,
                            random_implicit_pack_db)

    params = preset(args.preset)
    d = params.poly_len
    rng = np.random.default_rng(0)
    pack = "pack" in args.preset
    t0 = time.time()
    Client = PackClient if pack else SpiralClient
    client = Client(params, seed=1, device=device, nonoise=args.nonoise)
    pub = client.setup()
    sync(device)
    log(f"setup: {time.time() - t0:.1f}s")

    t0 = time.time()
    encoded = tracing.COUNTS["encoded_bytes"]
    tracing.enable(args.verbose)
    pts = None
    if args.implicit:
        random_implicit = random_implicit_pack_db if pack \
            else random_implicit_db
        db = random_implicit(params, rng, max_slab_bytes=args.slab_bytes,
                             device=device)
        log(f"implicit DB: slab_per={db.slab_per} chunks={db.num_chunks}")
    elif pack:
        pts = rng.integers(0, params.p_db, size=(
            params.total_n, params.out_n, params.out_n, d),
            dtype=pt_dtype(params))
        db = encode_pack_db(pts, params, device)
    else:
        pts = rng.integers(0, params.p_db,
                           size=(params.total_n, params.n0, params.n2, d),
                           dtype=pt_dtype(params))
        db = encode_db(pts, params, device)
    sync(device)
    tracing.enable(False)
    spans = [x for x in tracing.drain() if x.name == "spiral.encode"]
    log(f"db encode: {time.time() - t0:.1f}s ({len(spans)} spiral.encode "
        f"spans, {sum(x.end_ns - x.start_ns for x in spans) / 1e9:.1f}s; "
        f"encoded_bytes {tracing.COUNTS['encoded_bytes'] - encoded})")
    t0 = time.time()
    server = (PackServer if pack else SpiralServer)(params, db, pub)
    sync(device)
    log(f"server: {time.time() - t0:.1f}s")
    return params, pack, client, server, pts, rng


def _decodes(client, resp, pts, idx) -> bool:
    return bool(np.array_equal(client.decode(resp), pts[idx].astype(object)))


def run_batch(args, params, client, server, pts, rng, log) -> tuple[dict,
                                                                    int]:
    """bench.py's --batch branch: B queries per process_query_batch."""
    idxs = [int(rng.integers(0, params.total_n)) for _ in range(args.batch)]
    queries = [client.query(i) for i in idxs]
    best_s = float("inf")
    for t in range(max(1, args.trials)):
        resps, s = server.process_query_batch(queries)
        log(f"batch trial {t}: {s:.4f}s ({args.batch / s:.1f} queries/s)")
        best_s = min(best_s, s)
    correct = all(_decodes(client, r, pts, i) for i, r in zip(idxs, resps)) \
        if pts is not None else None
    log(f"batch correct: {correct}")
    # bench.py:145-146 counts n0*n2 polys a record here for every preset
    nbytes = db_bytes(params, pack=False)
    throughput = args.batch * nbytes / best_s / 1e6
    return {
        "metric": "spiral_server_throughput",
        "value": round(throughput, 2),
        "unit": "MB/s",
        "vs_baseline": round(throughput / BASELINE_THROUGHPUT_MBPS, 3),
        "detail": {"preset": args.preset, "batch": args.batch,
                   "correct": correct, "db_bytes": nbytes,
                   "batch_seconds": round(best_s, 4),
                   "queries_per_s": round(args.batch / best_s, 2),
                   "query_bytes": queries[0].size_bytes,
                   "response_bytes": params.response_size_bytes(),
                   "serving": server.serving},
    }, 0 if correct is not False else 1


def stage_fields(server, query, pack: bool, device: torch.device,
                 log) -> tuple[dict, str]:
    """bench.py's stage fields and their basis: device_stage_times for a
    packed Spiral query, else the second of two process_query runs."""
    from .profiling import device_stage_times

    cuda = device.type == "cuda"
    if query.packed_b is not None and not pack:
        # on the CPU one timed run: host-clock times of eager stages are no
        # device metric at any count
        kw = {} if cuda else {"iters": 1, "reps": 1}
        stages = device_stage_times(server, query, **kw)
        basis = "cuda_graph_events" if cuda else "host_clock"
    else:
        server.process_query(query)
        _, st = server.process_query(query)
        stages = {
            "expansion_us": round(st.expansion_us),
            "composition_us": round(st.composition_us),
            "conversion_us": round(st.conversion_us),
            "first_multiply_us": round(st.first_multiply_us),
            "folding_us": round(st.folding_us),
            "modswitch_us": round(st.modswitch_us),
            "fused_total_us": round(st.total_us),
        }
        basis = "cuda_graph_stages" if cuda else "host_clock"
    if query.packed_b is None:
        basis += ("; a direct query's reconstruction is in expansion_us "
                  "(bench.py's JAX server counts it in composition_us)")
    log(f"stages ({basis}): {stages}")
    return stages, basis


def run_single(args, params, pack, client, server, pts, rng,
               device: torch.device, log) -> tuple[dict, int]:
    """bench.py's single-query branch."""
    idx = int(rng.integers(0, params.total_n))
    query = client.query(idx)

    t0 = time.time()
    resp, fused_s = server.process_query_fused(query)
    log(f"warmup+first fused: {time.time() - t0:.1f}s "
        f"(fused time {fused_s:.4f}s)")
    correct = None if pts is None else _decodes(client, resp, pts, idx)
    log(f"correct: {correct}")
    best_s = fused_s
    for t in range(args.trials):
        _, s = server.process_query_fused(query)
        log(f"trial {t}: fused server time {s:.4f}s")
        best_s = min(best_s, s)

    # K distinct queries enqueued back to back, every response fetched at
    # the end: the host's share of a query overlaps the device's work
    stream = [client.query(int(rng.integers(0, params.total_n)))
              for _ in range(PIPELINED_QUERIES)]
    for x in server._run_single(stream[0]):
        x.cpu()
    t0 = time.perf_counter()
    outs = [server._run_single(q) for q in stream]
    [[x.cpu() for x in rows] for rows in outs]
    stream_s = (time.perf_counter() - t0) / len(stream)
    log(f"pipelined: {stream_s:.4f}s/query over {len(stream)} queries")

    # the host <-> device round trip floor: a trivial op, fetched
    one = torch.zeros((), dtype=torch.int32, device=device)
    (one + 1).item()
    t0 = time.perf_counter()
    for _ in range(3):
        (one + 1).item()
    rtt_s = (time.perf_counter() - t0) / 3
    log(f"rtt floor: {rtt_s:.6f}s")

    batch_detail = {}
    if not args.implicit:
        bqueries = stream[:BATCH]
        _, batch_s = server.process_query_batch(bqueries)
        _, batch_s2 = server.process_query_batch(bqueries)
        batch_s = min(batch_s, batch_s2)
        batch_detail = {
            "batch8_seconds": round(batch_s, 4),
            "batch8_queries_per_s": round(BATCH / batch_s, 2),
        }
        log(f"batch B={BATCH}: {batch_s:.4f}s ({BATCH / batch_s:.1f} "
            f"queries/s)")

    stages, basis = stage_fields(server, query, pack, device, log)

    nbytes = db_bytes(params, pack)
    serve_s = min(stream_s, best_s)
    throughput = nbytes / serve_s / 1e6
    if batch_detail:
        batch_detail["batch8_agg_MBps"] = round(
            BATCH * nbytes / batch_detail["batch8_seconds"] / 1e6, 1)
    return {
        "metric": "spiral_server_throughput",
        "value": round(throughput, 2),
        "unit": "MB/s",
        "vs_baseline": round(throughput / BASELINE_THROUGHPUT_MBPS, 3),
        "detail": {
            "preset": args.preset,
            "timing": "pipelined" if stream_s < best_s else "single",
            "correct": correct,
            "db_bytes": nbytes,
            "server_total_s": round(serve_s, 4),
            "single_query_wall_s": round(best_s, 4),
            "vs_baseline_single_query": round(
                nbytes / best_s / 1e6 / BASELINE_THROUGHPUT_MBPS, 3),
            "host_rtt_floor_s": round(rtt_s, 4),
            "pipelined_s": round(stream_s, 4),
            **batch_detail,
            **stages,
            "stage_basis": basis,
            "serving": server.serving,
            "query_bytes": query.size_bytes,
            "response_bytes": params.response_size_bytes(),
        },
    }, 0 if correct is not False else 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="spiral_20_256")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--batch", type=int, default=0,
                    help="serve B queries per process_query_batch (the "
                         "database streamed once per batch); reports "
                         "aggregate throughput")
    ap.add_argument("--implicit", action="store_true",
                    help="implicit random working-set DB (ref "
                         "--random-data): huge-DB throughput timing, "
                         "correctness unchecked")
    ap.add_argument("--slab-bytes", type=int, default=2 << 30)
    ap.add_argument("--nonoise", action="store_true",
                    help="skip noise sampling in client ops (debug only)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device the server runs on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)

    def log(*a):
        if args.verbose:
            print(*a, file=sys.stderr, flush=True)

    if device.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(device)}")
    params, pack, client, server, pts, rng = build(args, device, log)
    if args.batch:
        result, rc = run_batch(args, params, client, server, pts, rng, log)
    else:
        result, rc = run_single(args, params, pack, client, server, pts,
                                rng, device, log)
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
