"""Figure and benchmark harness of the port (counterpart of
spiral_tpu/harness.py; ref: run_all.py / run_scheme.py).

Figures:
    packingcomp   four-variant comparison on one scenario (the paper's
                  key table; ref: run_all.py:43-55)
    table         main-comparison rows: the packingcomp rows plus the
                  SealPIR / FastPIR / OnionPIR / NoPriv columns through
                  run_scheme (ref: run_all.py scenarios_table/get_cost)
    ubench        per-stage breakdown incl. client stages (ref: run_all.py
                  scenarios_ubench / print_summary taxonomy)
    asympcomp     scaling over logN at fixed itemsize (ref: run_all.py:17-19)
    streaming     huge-DB throughput via the implicit working set (ref:
                  run_all.py scenarios_streaming + --random-data)
    limits        upload-constrained deployments (ref: run_all.py
                  scenarios_limits)
    maxtotalquery rate and model time against an upload cap, per
                  constraint predicate (ref: run_all.py
                  scenarios_maxtotalquery)
    application   movie, Wikipedia and voice-call scenarios (ref: run_all.py
                  gen_application)
    dist          scaling of the database-dependent phase over meshes of
                  the first n ranks (row-sharded first dim, one
                  all-gather; dist/shard.py)

Every explicit-DB cell checks its decode and raises on a wrong record
(ref: run_all.py check_corr).  limits, maxtotalquery and application are
selection cells (paramgen.search.select_params, no server runs): sizes
and rate are exact, the model time is the H100 LUT's entry where the
selection is measured, else the proxy fitted to it.  The JAX
harness's ablation figure is not ported: its only switch,
SPIRAL_FDIM=u32, is not.

Server cost: cost_usd is the card's time at --usd-per-hour (no default:
without it cost_usd is null) plus the reference's egress price per
response byte.  Results are saved as JSON per figure under
results_torch/ (never the JAX harness's results/).

    python -m spiral_tpu_torch.harness packingcomp [--tiny] [--trials N]
    python -m spiral_tpu_torch.harness ubench --preset spiral_20_256
    python -m spiral_tpu_torch.harness streaming --logns 24,26,28
    python -m spiral_tpu_torch.harness limits [--max-query-mb 33]
    torchrun --nproc-per-node 4 -m spiral_tpu_torch.harness dist

Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .bench import pt_dtype, sync

VARIANTS = ("spiral", "spiralstream", "spiralpack", "spiralstreampack")

# the reference's egress price per response byte (ref: run_all.py:71-72)
USD_PER_BYTE = 9e-11

RESULTS_DIR = "results_torch"


def get_cost(total_us: float, resp_bytes: int,
             usd_per_hour: float | None) -> float | None:
    """Server cost of one query: total_us of the card at usd_per_hour plus
    the egress of resp_bytes; None without a price for the card."""
    if usd_per_hour is None:
        return None
    return usd_per_hour / 3600e6 * total_us + USD_PER_BYTE * resp_bytes


def _item_resp_bytes(params, pack: bool):
    logp = int(math.log2(params.p_db))
    if pack:
        item_b = params.out_n ** 2 * params.poly_len * logp // 8
        resp_b = (params.out_n ** 2 * params.poly_len * (logp + 2)
                  + params.out_n * params.poly_len *
                  params.q_prime_bits) // 8
    else:
        item_b = params.n0 * params.n2 * params.poly_len * logp // 8
        resp_b = params.response_size_bytes()
    return item_b, resp_b


def _client(pack: bool, params, seed: int, device):
    from .pack import PackClient
    from .pir import SpiralClient
    return (PackClient if pack else SpiralClient)(params, seed=seed,
                                                  device=device)


def run_variant(name: str, params, rng, trials: int = 1,
                want_stages: bool = False, device="cuda",
                usd_per_hour: float | None = None) -> dict:
    """One cell: a seeded client, a database drawn from `rng`, one query
    served by process_query_fused (best of `trials`), four more enqueued
    back to back (pipelined_s), the decode checked."""
    from .pack import PackServer, encode_pack_db
    from .pir import SpiralServer
    from .server.db import encode_db

    device = torch.device(device)
    pack = "pack" in name
    idx = int(rng.integers(0, params.total_n))
    t_setup0 = time.time()
    client = _client(pack, params, 1, device)
    t_kg0 = time.time()
    pub = client.setup()
    sync(device)
    key_gen_s = time.time() - t_kg0
    rec = (params.out_n, params.out_n) if pack else (params.n0, params.n2)
    pts = rng.integers(0, params.p_db,
                       size=(params.total_n, *rec, params.poly_len),
                       dtype=pt_dtype(params))
    if pack:
        server = PackServer(params, encode_pack_db(pts, params, device), pub)
    else:
        server = SpiralServer(params, encode_db(pts, params, device), pub)
    want = pts[idx].astype(object)
    sync(device)
    setup_s = time.time() - t_setup0

    t_qg0 = time.time()
    query = client.query(idx)
    sync(device)
    query_gen_s = time.time() - t_qg0
    best = None
    for _ in range(max(1, trials)):
        resp, server_s = server.process_query_fused(query)
        best = server_s if best is None else min(best, server_s)
    # steady-state serving: queries enqueued back to back, every response
    # fetched at the end
    stream = [client.query(int(rng.integers(0, params.total_n)))
              for _ in range(4)]
    t_p0 = time.perf_counter()
    outs = [server._run_single(q) for q in stream]
    [[x.cpu() for x in rows] for rows in outs]
    pipelined_s = (time.perf_counter() - t_p0) / len(stream)
    t_dec0 = time.time()
    out = client.decode(resp)
    decoding_s = time.time() - t_dec0
    correct = bool(np.array_equal(out, want))
    if not correct:
        wrong = (np.asarray(out) != np.asarray(want)).sum()
        print(f"{name}: incorrect decode idx={idx} "
              f"({wrong}/{np.asarray(want).size} coeffs wrong)",
              file=sys.stderr)

    item_b, resp_b = _item_resp_bytes(params, pack)
    db_b = params.total_n * item_b
    cost = get_cost(best * 1e6, resp_b, usd_per_hour)
    row = {
        "variant": name,
        "correct": correct,
        "query_b": query.size_bytes,
        "pub_b": pub.size_bytes,
        "resp_b": resp_b,
        "rate": round(item_b / resp_b, 4),
        "server_s": round(best, 4),
        "pipelined_s": round(pipelined_s, 4),
        "tput_MB_s": round(db_b / best / 1e6, 1),
        "cost_usd": None if cost is None else round(cost, 9),
        "setup_s": round(setup_s, 1),
    }
    if want_stages:
        server.process_query(query)
        _, st = server.process_query(query)
        # warm client stages: a fresh client's keygen and query
        t0 = time.time()
        client_w = _client(pack, params, 2, device)
        client_w.setup()
        sync(device)
        key_gen_warm_s = time.time() - t0
        t0 = time.time()
        client_w.query(idx)
        sync(device)
        query_gen_warm_s = time.time() - t0
        row["stages_us"] = {
            "key_gen": round(key_gen_warm_s * 1e6),
            "query_gen": round(query_gen_warm_s * 1e6),
            "key_gen_cold": round(key_gen_s * 1e6),
            "query_gen_cold": round(query_gen_s * 1e6),
            "expansion": round(st.expansion_us),
            "composition": round(st.composition_us),
            "conversion": round(st.conversion_us),
            "first_dim": round(st.first_multiply_us),
            "folding": round(st.folding_us),
            "packing": round(st.packing_us),
            "modswitch": round(st.modswitch_us),
            "decoding": round(decoding_s * 1e6),
        }
    return row


def run_streaming_cell(preset_name: str, trials: int, slab_bytes: int,
                       device="cuda") -> dict:
    """Implicit-DB throughput cell (timing only; ref --random-data)."""
    from .params import preset
    from .pir import SpiralClient, SpiralServer
    from .server.db import random_implicit_db

    params = preset(preset_name)
    rng = np.random.default_rng(0)
    client = SpiralClient(params, seed=1, device=device)
    pub = client.setup()
    db = random_implicit_db(params, rng, max_slab_bytes=slab_bytes,
                            device=device)
    server = SpiralServer(params, db, pub)
    query = client.query(0)
    best = None
    for _ in range(max(1, trials)):
        _, s = server.process_query_fused(query)
        best = s if best is None else min(best, s)
    item_b, _ = _item_resp_bytes(params, False)
    db_b = params.total_n * item_b
    return {
        "preset": preset_name,
        "log_records": params.nu_1 + params.nu_2,
        "db_MB": round(db_b / 1e6),
        "slab_per": db.slab_per,
        "chunks": db.num_chunks,
        "server_s": round(best, 4),
        "tput_MB_s": round(db_b / best / 1e6, 1),
    }


def scenario_params(tiny: bool):
    from .params import preset
    if tiny:
        return {
            "spiral": preset("tiny"),
            "spiralstream": preset("tiny_stream"),
            "spiralpack": preset("tiny_pack"),
            "spiralstreampack": preset("tiny_stream_pack"),
        }
    return {
        "spiral": preset("spiral_20_256"),
        "spiralstream": preset("spiralstream_20_256"),
        "spiralpack": preset("spiralpack_20_256"),
        "spiralstreampack": preset("spiralstreampack_20_256"),
    }


def _print_rows(rows, hdr):
    widths = [max(len(h), 18) for h in hdr]
    print("  ".join(h.ljust(w) for h, w in zip(hdr, widths)),
          file=sys.stderr)
    for r in rows:
        print("  ".join(str(r.get(h, "-")).ljust(w)
                        for h, w in zip(hdr, widths)), file=sys.stderr)


def _checked(row: dict, what: str) -> dict:
    if not row["correct"]:
        raise RuntimeError(f"{what} returned a wrong record")
    return row


def fig_packingcomp(args) -> list:
    rng = np.random.default_rng(0)
    rows = []
    for name in args.variants.split(","):
        params = scenario_params(args.tiny)[name]
        print(f"running {name}...", file=sys.stderr, flush=True)
        rows.append(_checked(run_variant(
            name, params, rng, args.trials, device=args.device,
            usd_per_hour=args.usd_per_hour), name))
    _print_rows(rows, ("variant", "query_b", "pub_b", "resp_b", "rate",
                       "server_s", "tput_MB_s", "cost_usd"))
    return rows


def fig_ubench(args) -> list:
    from .params import preset
    rng = np.random.default_rng(0)
    name = args.preset or ("tiny" if args.tiny else "spiral_20_256")
    variant = "spiralpack" if "pack" in name else "spiral"
    row = _checked(run_variant(variant, preset(name), rng, args.trials,
                               want_stages=True, device=args.device,
                               usd_per_hour=args.usd_per_hour), name)
    print(json.dumps(row["stages_us"], indent=2), file=sys.stderr)
    return [row]


def fig_asympcomp(args) -> list:
    """Spiral at increasing logN, fixed 256 B items (explicit DBs)."""
    from .params import Params
    rng = np.random.default_rng(0)
    rows = []
    for log_rec in (6, 8, 10, 12, 14) if args.tiny else (11, 13, 15):
        nu_1 = (log_rec + 1) // 2
        nu_2 = log_rec - nu_1
        p = Params(nu_1=nu_1, nu_2=nu_2, p_db=256, q_prime_bits=20,
                   t_gsw=8, t_conv=4, t_exp=8, t_exp_right=56,
                   poly_len=256 if args.tiny else 2048)
        print(f"asympcomp log_records={log_rec}...", file=sys.stderr,
              flush=True)
        row = _checked(run_variant("spiral", p, rng, args.trials,
                                   device=args.device,
                                   usd_per_hour=args.usd_per_hour),
                       f"log_records={log_rec}")
        row["log_records"] = log_rec
        rows.append(row)
    _print_rows(rows, ("log_records", "rate", "server_s", "tput_MB_s"))
    return rows


def fig_streaming(args) -> list:
    rows = []
    for logn in (int(x) for x in args.logns.split(",")):
        print(f"streaming 2^{logn} x 256 B (implicit)...", file=sys.stderr,
              flush=True)
        rows.append(run_streaming_cell(f"spiral_{logn}_256", args.trials,
                                       args.slab_bytes, args.device))
    _print_rows(rows, ("preset", "log_records", "db_MB", "chunks",
                       "server_s", "tput_MB_s"))
    return rows


def fig_table(args) -> list:
    """Main comparison table (ref: run_all.py:28-32 scenarios_table): the
    Spiral variants measured on this device (fig_packingcomp), plus
    SealPIR / FastPIR / OnionPIR / NoPriv columns via the run_scheme
    adapters.  Competitor binaries are external (env SEALPIR_BIN /
    FASTPIR_BIN / ONIONPIR_BIN); an absent system gives an `available:
    false` cell instead of aborting the figure (SystemUnavailable)."""
    from .run_scheme import SystemUnavailable, get_pp_size, run_system_tr

    rows = fig_packingcomp(args)
    scenario = "tiny" if args.tiny else "(20, 256)"
    for r in rows:
        r["scenario"] = scenario
    log_n, itemsize = (4, 256) if args.tiny else (20, 256)
    for system in ("sealpir", "fastpir", "onionpir", "nopriv"):
        cell = {"variant": system, "scenario": scenario}
        try:
            res = run_system_tr(system, log_n, itemsize,
                                trials=args.trials)
            cost = get_cost(res["total_us"], res["resp_sz"],
                            args.usd_per_hour)
            cell.update({
                "available": True,
                "query_b": res.get("query_sz", 0),
                "pub_b": get_pp_size(system, res) if system != "nopriv"
                else 0,
                "resp_b": res["resp_sz"],
                "rate": round(itemsize / res["resp_sz"], 4)
                if res["resp_sz"] else None,
                "server_s": round(res["total_us"] / 1e6, 4),
                "cost_usd": None if cost is None else round(cost, 9),
            })
        except SystemUnavailable as e:
            cell.update({"available": False, "reason": str(e)})
        rows.append(cell)
    return rows


def _dryrun_cell(system: str, log_n: int, itemsize: int, **constraints):
    """Selection/model cell (the reference's select_params --dry-run path):
    sizes and rate are exact; server time is the model cost (an entry of
    the H100 LUT when one exists, else the proxy fitted to it)."""
    from .paramgen.search import select_params
    pack = "pack" in system
    direct = "stream" in system
    try:
        sel = select_params(log_n, itemsize, direct_upload=direct,
                            pack=pack, **constraints)
    except ValueError:
        return {"system": system, "log_n": log_n, "itemsize": itemsize,
                "feasible": False}
    p = sel.params
    _, resp_b = _item_resp_bytes(p, pack)
    resp_total = resp_b * sel.factor
    db_b = (1 << log_n) * itemsize
    return {
        "system": system, "log_n": log_n, "itemsize": itemsize,
        "feasible": True, "factor": sel.factor,
        "query_sz": p.query_size_bytes(),
        "param_sz": p.public_param_size_bytes(),
        "resp_sz": resp_total,
        "rate": round(itemsize / resp_total, 4),
        "model_server_s": round(abs(sel.cost), 4),
        "model_tput_MB_s": round(db_b / abs(sel.cost) / 1e6, 1)
        if constraints.get("optimize_for", "") != "rate" else None,
        "params": {"nu_1": p.nu_1, "nu_2": p.nu_2, "p_db": p.p_db,
                   "t_gsw": p.t_gsw, "t_conv": p.t_conv, "t_exp": p.t_exp,
                   "q_prime_bits": p.q_prime_bits, "out_n": p.out_n},
    }


def fig_limits(args) -> list:
    """Upload-constrained deployments (ref: run_all.py scenarios_limits):
    SpiralStream/SpiralStreamPack under a max online-query size."""
    rows = []
    cap = args.max_query_mb * 1_000_000
    for log_n, itemsize in ((20, 256), (18, 30000), (14, 1000000)):
        for system in ("spiralstream", "spiralstreampack"):
            rows.append(_dryrun_cell(system, log_n, itemsize,
                                     max_query_bytes=cap))
    _print_rows(rows, ("system", "log_n", "itemsize", "rate", "param_sz",
                       "query_sz", "resp_sz", "model_server_s"))
    return rows


def fig_maxtotalquery(args) -> list:
    """Rate/tput vs upload cap, per constraint predicate
    (ref: run_all.py scenarios_maxtotalquery)."""
    kinds = {"query": "max_query_bytes", "param": "max_param_bytes",
             "total-query": "max_total_query_bytes"}
    rows = []
    for mb in (1, 2, 5, 10, 20, 30, 40, 50, 60, 70):
        for kind, kw in kinds.items():
            for system in VARIANTS:
                cell = _dryrun_cell(system, 14, 100000,
                                    **{kw: mb * 1_000_000})
                cell["cap_mb"], cell["predicate"] = mb, kind
                rows.append(cell)
    _print_rows([r for r in rows if r["feasible"]],
                ("system", "cap_mb", "predicate", "rate", "query_sz",
                 "param_sz"))
    return rows


def fig_application(args) -> list:
    """Application scenarios (ref: run_all.py gen_application): movie
    streaming (2^14 x 2 GB), Wikipedia (2^20 x 30 KB), voice call
    (625 rounds of 2^14 x 6144 B).  Oversized items use the factored
    pipeline; cells are selection/model numbers (the reference likewise
    scales one measured pass by `factor`)."""
    rows = []
    for system in ("spiralstream", "spiralstreampack"):
        c = _dryrun_cell(system, 14, 2_000_000_000,
                         max_query_bytes=33_000_000)
        c["scenario"] = "movie"
        rows.append(c)
    for system in VARIANTS:
        c = _dryrun_cell(system, 20, 30000)
        c["scenario"] = "wiki"
        rows.append(c)
    for system in ("spiralstream", "spiralstreampack"):
        c = _dryrun_cell(system, 14, 6144, max_query_bytes=33_000_000)
        if c["feasible"]:
            rounds = 625
            c["resp_sz"] *= rounds
            c["model_server_s"] = round(c["model_server_s"] * rounds, 3)
            c["rate"] = round(6144 * rounds / c["resp_sz"], 4)
        c["scenario"] = "voice(625)"
        rows.append(c)
    _print_rows(rows, ("scenario", "system", "rate", "query_sz", "param_sz",
                       "resp_sz", "model_server_s"))
    return rows


def fig_dist(args) -> list | None:
    """Scaling of the database-dependent phase (row-sharded first dim,
    local fold rounds, one all-gather, the replicated tail) over meshes of
    the first n ranks, n from --devices: T(1)/(n*T(n)) per size, every
    explicit-DB row decode-checked (a wrong record raises).  It runs in
    the caller's world (torchrun, multihost.initialize), else in a world
    of one; sizes above the world's are dropped, as the JAX figure drops
    those above its device count, and size 1 is the unsharded server.
    Every rank builds the same client, database and query from the seeds
    and takes part in making each mesh; the ranks of a mesh serve, and
    rank 0 times.  Rank 0 returns the rows, every other rank None."""
    from .dist import multihost, shard
    from .params import Params, preset
    from .pir import SpiralClient, SpiralServer
    from .server.db import encode_db, random_db, random_implicit_db

    with multihost.world(args.device):
        world, rank = dist.get_world_size(), dist.get_rank()
        device = torch.device(args.device)
        if args.tiny:
            params = Params(nu_1=2, nu_2=3, p_db=256, q_prime_bits=20,
                            t_gsw=8, t_conv=4, t_exp=8, t_exp_right=8,
                            poly_len=256)
        else:
            params = preset(args.preset or "spiral_20_256")
        rng = np.random.default_rng(0)
        client = SpiralClient(params, seed=1, device=device)
        pub = client.setup()
        if args.implicit:
            db = random_implicit_db(params, rng,
                                    max_slab_bytes=args.slab_bytes,
                                    device=device)
            pts = None
        else:
            pts = random_db(params, rng)
            db = encode_db(pts, params, device)
        idx = int(rng.integers(0, params.total_n))
        query = client.query(idx)

        sizes = [n for n in map(int, args.devices.split(",")) if n <= world]
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        rows, t1 = [], None
        for n in sizes:
            mesh = shard.make_db_mesh(n, device) if n > 1 else None
            if rank >= n:
                continue
            server = SpiralServer(params, db, pub, mesh=mesh)
            best = None
            for _ in range(max(1, args.trials)):
                resp, s = server.process_query_fused(query)
                best = s if best is None else min(best, s)
            correct = None
            if pts is not None:
                correct = bool(np.array_equal(client.decode(resp),
                                              pts[idx].astype(object)))
                if not correct:
                    raise RuntimeError(f"mesh size {n}: wrong record")
            t1 = best if t1 is None else t1
            rows.append({"devices": n, "server_s": round(best, 4),
                         "correct": correct, "speedup": round(t1 / best, 3),
                         "efficiency": round(t1 / (n * best), 3),
                         "device": name})
    if rank:
        return None
    _print_rows(rows, ("devices", "server_s", "speedup", "efficiency"))
    return rows


FIGURES = {
    "packingcomp": fig_packingcomp,
    "dist": fig_dist,
    "table": fig_table,
    "ubench": fig_ubench,
    "asympcomp": fig_asympcomp,
    "streaming": fig_streaming,
    "limits": fig_limits,
    "maxtotalquery": fig_maxtotalquery,
    "application": fig_application,
}


# ---------------------------------------------------------------------------
# Result persistence + rendering (ref: run_all.py:82-94 pickle/--load,
# :206-232 LaTeX/plain tabulate).  Results are saved as JSON per figure so
# figures can be re-rendered (or post-processed) without re-running.

def save_results(figure: str, rows: list, results_dir: str = RESULTS_DIR):
    p = pathlib.Path(results_dir)
    p.mkdir(parents=True, exist_ok=True)
    path = p / f"{figure}_results.json"
    path.write_text(json.dumps(rows, indent=1, default=str))
    return str(path)


def load_results(figure: str, results_dir: str = RESULTS_DIR) -> list:
    path = pathlib.Path(results_dir) / f"{figure}_results.json"
    if not path.exists():
        raise FileNotFoundError(
            f"no saved results for '{figure}' in {results_dir}; run the "
            f"figure first")
    return json.loads(path.read_text())


def render_table(rows: list, fmt: str = "plain") -> str:
    """Render result rows as a plain or LaTeX table (ref:
    run_all.py:206-232)."""
    if not rows:
        return ""
    cols = []
    for r in rows:
        for k in r:
            if k not in cols and not isinstance(r[k], (dict, list)):
                cols.append(k)
    cells = [[("" if r.get(c) is None else str(r.get(c, "")))
              for c in cols] for r in rows]
    if fmt == "latex":
        lines = ["\\begin{tabular}{" + "l" * len(cols) + "}", "\\hline",
                 " & ".join(c.replace("_", "\\_") for c in cols) +
                 " \\\\", "\\hline"]
        lines += [" & ".join(row) + " \\\\" for row in cells]
        lines += ["\\hline", "\\end{tabular}"]
        return "\n".join(lines)
    widths = [max(len(cols[i]), *(len(row[i]) for row in cells))
              for i in range(len(cols))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    lines += ["  ".join(v.ljust(w) for v, w in zip(row, widths))
              for row in cells]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("figure", nargs="?", default="packingcomp",
                    choices=sorted(FIGURES))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--preset", default=None)
    ap.add_argument("--logns", default="24,26,28")
    ap.add_argument("--slab-bytes", type=int, default=2 << 30)
    ap.add_argument("--max-query-mb", type=int, default=33)
    ap.add_argument("--devices", default="1,2,4,8",
                    help="dist: the mesh sizes (ranks), those above the "
                         "world's dropped")
    ap.add_argument("--implicit", action="store_true",
                    help="dist: an implicit database (--slab-bytes)")
    ap.add_argument("--device", default="cuda",
                    help="the device the servers run on (default cuda)")
    ap.add_argument("--usd-per-hour", type=float, default=None,
                    help="the card's price per hour, for cost_usd (null "
                         "without it)")
    ap.add_argument("--load", action="store_true",
                    help="re-render saved results instead of re-running "
                         "(ref: run_all.py --load)")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--format", choices=("json", "plain", "latex"),
                    default="json")
    args = ap.parse_args(argv)

    if args.load:
        rows = load_results(args.figure, args.results_dir)
    else:
        rows = FIGURES[args.figure](args)
        if rows is None:        # a rank other than 0 of the dist figure
            return 0
        path = save_results(args.figure, rows, args.results_dir)
        print(f"saved: {path}", file=sys.stderr)

    if args.format == "json":
        print(json.dumps(rows), flush=True)
    else:
        print(render_table(rows, args.format), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
