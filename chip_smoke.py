#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernels-only]

Phases, each printing its own lines and its wall time:
  1. the card: torch.cuda.is_available() (exit 1 without it) and
     nvidia-smi's name and power limit;
  2. build of the CUDA kernels from spiral_tpu_torch/csrc (one nvcc per
     source, in parallel): K1 ntt, K2 firstdim, K3 fold, K4 expand,
     K5 fold_batch and fold_pack_batch, K6 fold_pack, K7 pack, K8a auto,
     K8b fold_ntt and fold_contract, K9 compose and convert, K10
     threefry;
  3. each kernel against its plain PyTorch version on the card, for bit
     equality, with both times and the kernel's bound: K1-K4 at the
     spiral_20_256 shapes; K1, K2, K4, K6 and K7 at the spiralpack_20_256
     shapes; K5 (both forms) and K2 batched at B = 8 of both paths (and
     at B = 2, 3, 4 and 16 on the spiral_20_256 database), K2 chunked at
     the spiral_24_256 slab, and K3, K4, K5 at spiral_24_256's
     new digit widths; K8a at the first and the largest expansion round
     of spiral_20_256, one query's and a batch's, K8b's two kernels at
     fold rounds 1 (t_gsw 9 and 8) and the last, and at spiral_24_256's
     round 1 (t_gsw 11), and K8b-2 at round 1 on p - 1 in every word;
     K3, K4 and K6 at the edges of their clusters (one ct, m_out 1 and 5,
     t_gsw 8, 9 and 11); K9 at the four benchmark cells' shapes
     (k9_cases: the composition of 256, 1,024 and 8 x 256 cts, the
     conversion of 63, 72 and 8 x 63); K10 at the four cells' replay (one
     packed ct, a query and a batch of 8) and the stream variant's 542
     direct cts (k10_cases); the stream presets' shapes
     (stream_cases: K3 and K5 at t_gsw 5, K6 and K5's pack form at t_gsw
     3, K7 at m_conv 56, K2 on both stream databases at B = 1 and 8);
     then every fold
     round of spiral_20_256 (t_gsw
     9) and spiral_24_256 (t_gsw 11), and round 1 at t_gsw 8, as K3 and
     as a K8b round (K8b-1, K8b-2, K1) on the same inputs, both times on
     one line with the engine the fold picks for it;
  3b. K4 at each of the expansion's launches of one spiral_20_256 query
     (16), one spiral_24_256 query (18) and one query at the parameters
     select_params picks for 2^18 x 30,000 B records (SELECTED: 19, at m
     32 and 56 over g 11 rounds), each held bit-equal to its plain
     version and timed, with the sum per query;
  3c. K1 at each of its 2 launches in one spiral_20_256 query (the
     expansion's constants cached: the query's a and first dim; and one
     closing each fold round that runs K8b, none at spiral_20_256) and
     K8a at each of its 9 (one per expansion round), and K8a at each of the 11 rounds of a SELECTED query, each
     held bit-equal to its plain version and timed, with the sums and
     bounds per query;
  3d. the SELECTED parameters' fold and first dimension: K3 at each of
     its 8 fold rounds (factor 4 x 256 cts folded as one axis, t_gsw 9),
     and K2 over its whole (2, 2048, 2048, 2048) encoded layout (64 GiB of
     random residues, K 2,048), timed on the whole layout beside its
     bound and held bit-equal to the plain multiply on a slice of
     SELECTED_K2_COLS columns with the full reduction axis (--kernels-only
     stops here and prints the phase 3-3d JSON);
  4. Spiral: a tiny flow on the card against the plain CPU flow (equal
     response rows), then end to end at spiral_20_256: a seeded client, a
     2^20 x 256 B database from a numpy seed encoded on the card, and
     three queries (index 0, total_n - 1 and a random one), each decoded
     against its record, launching K1 as often as phase 3c lists and K9
     once for each of composition and conversion, with every kernel's
     launch count over that run; every graph the server captured (stage
     chain, served query, batch) records one K9 launch of each mode;
     then a batch of 8 (indices 0, total_n - 1 and six random ones) in
     one process_query_batch, each answer decoded and equal to its
     single-query rows; then the same three queries with the fold forced
     to K3 in every round and to K8b in every round, each decoded and
     equal to the default server's rows;
  5. SpiralPack, the same at tiny_pack and spiralpack_20_256 (2^20 x 256 B
     as 8,192 records of 4 x 4 polys), after the Spiral database is freed;
  6. the implicit huge-database mode at spiral_24_256 (2^24 x 256 B
     served from a 2 GiB random slab streamed 32 times): one query (served
     twice: the first also pays for the fold's first device memory) and a
     batch of 8 holding it, whose rows for it must equal the single run's
     (the answers cannot decode: the slab is random); then that query
     with the fold forced to K3 and to K8b in every round, whose rows must
     equal the default server's;
  7. the Stream variants: tiny_stream, tiny_subround (whose subround
     parts must launch K4 and K8a on the card) and tiny_stream_pack on
     the card against the plain CPU flow, then spiralstream_20_256 as in
     phase 4 (both query parts uploaded directly: K4 and K8a must not
     launch) and spiralstreampack_20_256 as in phase 5, each database
     freed before the next;
  8. oversized items (spiral_tpu_torch/factored.py): spiral_20_256 with
     13 sub-databases (26 GiB encoded, each drawn and encoded in turn,
     traced: one spiral.encode span a sub-database, their host seconds
     the encode's, and tracing.COUNTS["encoded_bytes"] grown by the
     database's bytes, or the run fails),
     three queries through process_query and process_query_fused, all 13
     chunks of each decoded, one K2 launch per run; then K2 at the
     factored shape (m 3,328) on the real database and K3's round 1
     (m_out 832) on the real first-dimension output against their plain
     versions;
  9. the measurement layer, after every earlier phase's database is
     freed: at spiral_20_256 profiling.device_stage_times (the served
     graph replayed between CUDA events, its stages read from the events
     it records; replayed rows other than the eager rows fail the run)
     beside three runs of process_query's stage chain (one CUDA graph per
     stage, CUDA events between the replays; its rows equal _run_eager's,
     and each stage's median within max(10%, 50 us) of the served graph's
     stage, or the run fails), the served graph's stage sum
     (last_timings) against its replay timed by two events around it in
     three replays (within 3%, or the run fails), process_query_fused's
     seconds and the device's busy share of served queries from a
     torch.profiler trace, the response after profiling equal to the one
     before and the stage sum equal to fused_total_us;
     then the port's bench (python -m spiral_tpu_torch.bench) at
     spiral_20_256 and at spiral_24_256 --implicit, harness ubench at
     spiral_20_256 and harness packingcomp at the four full presets, in
     this process, each printing its JSON line and launching every
     kernel of its path (K1-K4, K8a and K5 in the bench's batch of 8;
     chunked K2 and K8b implicit; K6 and K7 in packingcomp); a wrong
     decode fails the run;
 10. parameter selection (paramgen/, select_params.py): select_params'
     main at (20, 256) on the card, Spiral and then --pack, each served
     twice and decoded ("is_corr" must be true) over the parameters the
     H100 LUT ranks first; the --dry-run selection at (14, 100000) and
     whether it is measured; build_lut measuring spiral_20_256 into a
     temporary file (its entry correct, with the port's tag and this
     card; the committed LUT untouched); harness limits and application
     (selection cells), each JSON line printed;
 11. scale-out (dist/), in a real NCCL process group of one rank made in
     this process on a free localhost port and destroyed at the end of the
     phase: at spiral_20_256 the sharded SpiralServer (mesh of 1) against
     the unsharded one over the same 2 GiB database, three queries (rows
     equal, decoded; process_query and process_query_fused times of
     both), a batch of 8 (rows equal), check_graph_serving on the sharded
     server (its all-gather captured in its graphs) and its served
     graph's rows against the unsharded server's,
     multihost.ingest_and_serve (the
     database encoded again by encode_db_local; rows equal) and
     sharded_firstdim_and_fold (equal to the unsharded fold output); then
     worlds 2 and 4 one rank at a time on the one card (each rank's column
     block through K2, timed with CUDA events beside its byte bound, its
     local rounds, the survivors stacked in rank order as the all-gather
     stacks them, the tail and the modulus switch: rows equal to the
     unsharded rows); the sharded PackServer at spiralpack_20_256 and the
     sharded implicit spiral_24_256 query (rows equal to the unsharded
     servers'; check_graph_serving on both, the implicit one without a
     batch, and their served graphs' rows against the unsharded
     servers'); graft_entry's step and dryrun_multichip(1); harness dist
     --devices 1 (one row, correct).  The card has no peer here, so no
     multi-card time is measured.
Phases 4-8 also check the served path as CUDA graphs (graphs.py,
check_graph_serving) at spiral_20_256, spiralpack_20_256, spiral_24_256
implicit, spiralstream_20_256, spiralstreampack_20_256 and the factored
x 13 (and phase 11's mesh-of-one servers): process_query (the stage
chain) and _run_single in turn on two queries each give the eager rows
(the chain is not clobbered by the served graph); 8 distinct queries
enqueued back to back through _run_single and
fetched at the end each decode to their own record (implicit: each
equals its eager rows); a warm served query makes no host sync in its
enqueue and, in a torch.profiler trace, one cudaGraphLaunch and no kernel
launch; a batch of 8 replayed twice equals its eager run (not factored,
whose served tail graph is timed in process_query_fused).  Each prints
the stage chain's split of three process_query runs beside the device
time of a traced served query, the served and pipelined seconds eager
and as a graph, the device's busy share of each, and the capture seconds
and pool bytes of each graph (the stage chain's summed over its graphs,
captured by the first process_query of each path, capture_chain); the
line "graphs {...}" before the kernels' JSON holds them all.  Each
server's captured programs are then listed with the launches one replay
makes and their pool bytes (report_captures); every program that takes a
query's seeds records exactly one K10 launch, or the run fails.  Since the
servers serve through graphs, the process_query, served, batch and
pipelined runs of phases 4-11 replay graphs, the mesh servers' too; the
fold forced to one engine releases the server's graphs before and after
(a graph replays the engine its capture saw).
Phases 4, 5 and 7 also send one query of each full preset over the wire
(serialize.py: query bytes -> process_query_fused -> response bytes ->
decode, equal to its process_query rows), count the host syncs torch
reports inside the fused path's enqueue, rebuild the server from the
public parameters' bytes, and at spiral_20_256 check final_ciphertext and
round-trip the 2 GiB encoded database through save_db / load_db.
Each driven path counts launches from 0 and fails if a kernel of the path
was never launched; a graph replay counts each kernel its capture
recorded (a capture itself launches nothing).  The line before last is the kernels' JSON, the last
line {"ok": true, "device": {...}}.  Any failure raises and exits nonzero.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

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
# K8b-2's and K2's int8 multiply-adds run on the tensor cores: the H100
# SXM's dense int8 peak, 1,979 TOPS (NVIDIA H100 data sheet), counts two
# operations per multiply-add
INT8_MACS_PER_S = 1979e12 / 2
# K2's work is counted at the card's cheapest exact route: a modular
# product of two 32-bit words as 16 int8 multiply-adds of 8-bit limbs
K2_MACS_PER_PRODUCT = 16
# K10's work: a threefry2x32 hash is 20 mixes of add, funnel shift and
# xor and 5 key injections; the bound counts the 20 funnel shifts and 20
# xors, which only the integer ALU executes (64 a clock an SM, the
# integer rate), since the additions may run on the FMA pipe as IMAD
K10_OPS_PER_HASH = 40

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
    "fold_batch": ("spiral_tpu_torch/csrc/fold.cu",
                   "spiral_tpu/server/fold_pallas.py:512"),
    "fold_pack_batch": ("spiral_tpu_torch/csrc/fold.cu",
                        "spiral_tpu/server/fold_pallas.py:512"),
    "auto": ("spiral_tpu_torch/csrc/expand.cu",
             "spiral_tpu/server/expand_pallas.py:92"),
    "fold_ntt": ("spiral_tpu_torch/csrc/fold_mxu.cu",
                 "spiral_tpu/server/fold_pallas.py:704"),
    "fold_contract": ("spiral_tpu_torch/csrc/fold_mxu.cu",
                      "spiral_tpu/server/fold_pallas.py:766"),
    "compose": ("spiral_tpu_torch/csrc/convert.cu",
                "none: XLA matmuls, spiral_tpu/server/convert.py:39"),
    "convert": ("spiral_tpu_torch/csrc/convert.cu",
                "none: XLA matmuls, spiral_tpu/server/convert.py:56"),
    "threefry": ("spiral_tpu_torch/csrc/threefry.cu",
                 "none: jax.random in XLA, spiral_tpu/core/sampling.py:55"),
}
KERNEL_NOTES = {
    "firstdim": "two forms on the int8 tensor cores, by the pass's query "
                "rows: the one-query cases (3 or 2 rows) run the "
                "prescaled form, the batches of 8 (24 or 16 rows) the "
                "pair form; bound counts 16 int8 MACs per modular product "
                "and the slab once per chunk",
    "fold_contract": "replaces an XLA dot_general (_fold_contract_mxu, "
                     "with the prescale _fold_qpre), not a pallas_call: "
                     "the JAX mxu fold's contraction outside its Pallas "
                     "kernel _fold_ntt_call",
    "threefry": "products count the integer ALU's uint32 operations "
                "(K10_OPS_PER_HASH a hash, four hashes a counter) at the "
                "integer rate",
}
# the default single-query fold runs K8b-1 and K8b-2 in its large rounds
# at t_gsw 11 (fold.round_uses_mxu: rounds 1-4 at spiral_24_256, none at
# spiral_20_256) and K3 in the others
SPIRAL_PATH = ("ntt", "firstdim", "fold", "expand", "auto", "compose",
               "convert", "threefry")
IMPLICIT_PATH = SPIRAL_PATH + ("fold_ntt", "fold_contract")
PACK_PATH = ("ntt", "firstdim", "expand", "auto", "fold_pack", "pack",
             "threefry")
SPIRAL_BATCH_PATH = ("ntt", "firstdim", "expand", "auto", "fold_batch",
                     "compose", "convert", "threefry")
PACK_BATCH_PATH = ("ntt", "firstdim", "expand", "auto", "fold_pack_batch",
                   "pack", "threefry")
# the stream presets upload every ct directly: no expansion at
# spiralstream_20_256 (both parts direct), so no K4 and no K8a; every
# query's a halves are replayed from its seed (K10)
STREAM_PATH = ("ntt", "firstdim", "fold", "compose", "convert", "threefry")
STREAM_BATCH_PATH = ("ntt", "firstdim", "fold_batch", "compose", "convert",
                     "threefry")
STREAM_NOT = ("expand", "auto")
STREAM_PACK_PATH = ("ntt", "firstdim", "fold_pack", "pack", "threefry")
STREAM_PACK_BATCH_PATH = ("ntt", "firstdim", "fold_pack_batch", "pack",
                          "threefry")
# tiny_subround expands both parts of its query on the card
SUBROUND_PATH = ("expand", "auto", "threefry")
# the fold's engine forced in every round: (tag, fold.MXU_MIN_COLS, the
# kernels it must launch, the kernels it must not)
FOLD_FORCED = (("K3 every round", {}, ("fold",), ("fold_ntt",
                                                  "fold_contract")),
               ("K8b every round", collections.defaultdict(int),
                ("fold_ntt", "fold_contract"), ("fold",)))
# phases 3b-3d also run the kernels at the parameters the system selects
# for the paper's 2^18 x 30,000 B database (pirbench's spiral_18_30000
# configuration), shapes no preset has: K4 at m 32 over g 11 rounds, K8a
# over 11 rounds, K3 over factor x num_per cts at nu_2 8, K2 at K 2,048
SELECTED = (18, 30000)
# phase 3d's plain first-dim multiply runs on this many columns of that
# database, with the whole reduction axis
SELECTED_K2_COLS = 256
# the oversized-item configuration of phase 8: a 100,000-B item at
# spiral_20_256 is served as 13 sub-databases (the JAX package's
# paramgen.search.select_params(14, 100000): the spiral_20_256 parameters
# with factor 13), 26 GiB encoded on the card
FACTORED_PRESET, FACTOR = "spiral_20_256", 13
# the preset whose wire phase also checks final_ciphertext and round-trips
# its 2 GiB encoded database through save_db / load_db
CHECKPOINT_PRESET = "spiral_20_256"
BATCH = 8
# phase 9: the stage split's preset and runs, the tolerance of its stage
# sum against fused_total_us (each stage is rounded to a microsecond and
# clamped at 0, as in the JAX profiler), and the measurement runs: (tag,
# module, argv, the kernels the run must launch)
MEASURE_PRESET = "spiral_20_256"
MEASURE_RUNS = 3
STAGE_SUM_TOLERANCE = 0.01
# a stage chain's stage (process_query) against the served graph's stage
# (profiling.device_stage_times): the larger of the two bounds
CHAIN_TOLERANCE = 0.10
CHAIN_TOLERANCE_US = 50
# the served graph's stage sum (its own events) against its replay timed
# by two events around graph.replay()
SERVED_SUM_TOLERANCE = 0.03
MEASURE_RUNS_ARGV = (
    ("bench spiral_20_256", "bench", ["--preset", "spiral_20_256"],
     SPIRAL_PATH + ("fold_batch",)),
    ("bench spiral_24_256 --implicit", "bench",
     ["--preset", "spiral_24_256", "--implicit"], IMPLICIT_PATH),
    ("harness ubench spiral_20_256", "harness",
     ["ubench", "--preset", "spiral_20_256"], SPIRAL_PATH),
    ("harness packingcomp", "harness", ["packingcomp"],
     SPIRAL_PATH + ("fold_pack", "pack")),
)
# phase 10: select_params' runs on the card (tag, argv, the kernels the run
# must launch), the dry-run case, build_lut's preset and the selection
# figures
PARAMGEN_RUNS = (
    ("select_params 20 256", ["20", "256", "--trials", "2"], SPIRAL_PATH),
    ("select_params 20 256 --pack", ["20", "256", "--pack", "--trials", "2"],
     PACK_PATH),
)
PARAMGEN_DRY = ["14", "100000", "--dry-run"]
LUT_PRESET = "spiral_20_256"
PARAMGEN_FIGURES = ("limits", "application")
# phase 11: its presets, the worlds run one rank at a time on the one card
# (the K2 block each card of such a deployment streams) and the kernels of
# its contraction-sharded and one-rank-at-a-time runs
DIST_PRESET = "spiral_20_256"
DIST_PACK_PRESET = "spiralpack_20_256"
DIST_IMPLICIT_PRESET = "spiral_24_256"
DIST_WORLDS = (1, 2, 4)
DIST_BATCH_WORLD = 2
DIST_FOLD_PATH = ("ntt", "firstdim", "fold")
# a kernel whose mean over back-to-back launches is below this (the least
# of TIMINGS event timings) is timed again as the replay of a CUDA graph of
# those launches
GRAPH_BELOW_MS = 0.1
TIMINGS = 3
# the served path as CUDA graphs (check_graph_serving): distinct queries
# enqueued back to back (bench.py's K), and the served runs timed in turns
GRAPH_QUERIES = 8
SERVED_RUNS = 3
# each path's served numbers (check_graph_serving), printed before the end
GRAPHS: dict[str, dict] = {}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _events_ms(run) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, reps: int, timings: int = TIMINGS) -> tuple[float, str]:
    """Mean ms of fn() over reps launches, CUDA events, after one warm-up,
    the least of `timings` such timings, and how it was timed.  Below
    GRAPH_BELOW_MS the back-to-back launches may time the host's enqueue
    gaps, so the reps are captured in a CUDA graph and its replay is timed
    instead ("graph"), again the least of `timings`.  The least, not one
    mean, decides: a host stall in one timing does not hide a short
    kernel's time."""
    def loop():
        for _ in range(reps):
            fn()      # each output is freed before the next launch

    fn()
    ms = min(_events_ms(loop) for _ in range(timings)) / reps
    if ms >= GRAPH_BELOW_MS:
        return ms, "events"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop()
    graph.replay()
    return min(_events_ms(graph.replay) for _ in range(timings)) / reps, \
        "graph"


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


def k9_products(N: int, d: int, conv: bool) -> int:
    """K9 launch: per (ct, limb) the inverse NTT and the 4 digit NTTs of
    row 0 (and of row 1 when converting), each slot of a digit multiplied
    into the 6 composed polys (and the 3 V sums when converting)."""
    rows, outs = (2, 12) if conv else (1, 6)
    return N * 2 * (rows * 5 * ntt_products(d) + outs * 4 * d)


def expand_products(N: int, m: int, d: int) -> int:
    """K4 launch: per (ct, limb) m digit NTTs, each slot multiplied into
    two rows, and the NTT of row 1."""
    return N * 2 * (m * (ntt_products(d) + 2 * d) + ntt_products(d))


def check_kernels(seed: int) -> dict:
    """Phase 3: kernel vs plain version on the card, at the main paths'
    shapes.  Returns {kernel: {case: record}} for the JSON line; each
    kernel's first case is its main-path shape."""
    from spiral_tpu_torch.arith import ntt
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.server import expand, firstdim, fold

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
                  lambda: firstdim.multiply_plain(db, qk), 5, [db, qk], 0,
                  K2_MACS_PER_PRODUCT * 2 * d * K * m * n1))
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
        cases.append((f"expand_m{mk}", "expand",
                      lambda cv=cv, ca=ca, W=W, mk=mk: expand.keyswitch(
                          cv, ca, W, mk),
                      lambda cv=cv, ca=ca, W=W, mk=mk: expand.keyswitch_plain(
                          cv, ca, W, mk), 5, [cv, ca, W],
                      expand_products(N, mk, d)))
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
        cases.append((f"expand_m{mk}_pack", "expand",
                      lambda cv=cv, ca=ca, W=W, mk=mk: expand.keyswitch(
                          cv, ca, W, mk),
                      lambda cv=cv, ca=ca, W=W, mk=mk: expand.keyswitch_plain(
                          cv, ca, W, mk), 5, [cv, ca, W],
                      expand_products(N, mk, d)))
    # K2 at the pack path's shape: n1 = 2 rows, K = dim0, m = T*num_per
    Kp, mp = pp.dim0, T * pp.num_per
    pdb = rand_residues(gen, (d, Kp, mp), 0)
    pqk = rand_residues(gen, (Kp, 2, d))
    cases.append(("firstdim_pack", "firstdim",
                  lambda: firstdim.multiply_query_by_db(pdb, pqk),
                  lambda: firstdim.multiply_plain(pdb, pqk), 5, [pdb, pqk],
                  0, K2_MACS_PER_PRODUCT * 2 * d * Kp * mp * 2))
    # K7, out_n 4, m_conv 4
    cases.append(pack_case(gen, "pack", (), pp.out_n, pp.m_conv))

    cases += batch_cases(gen)
    cases += k9_cases(gen)
    cases += k10_cases()
    cases += mxu_cases(gen)
    cases += edge_cases(gen)
    cases += stream_cases(gen)

    results = {}
    for case in cases:
        results.setdefault(case[1], {})[case[0]] = check_case(*case)
    return results


def check_case(name, kernel, run, plain, reps, inputs, prods, macs=0,
               part=None) -> dict:
    """One kernel case: the kernel's output against its plain version's
    (tolerance 0), the kernel timed as cuda_ms does over `reps` launches,
    the plain version once, and the bound from the inputs' and output's
    bytes, `prods` modular products and `macs` int8 tensor-core
    multiply-adds.  part: a view of the output that the plain version
    computes (default the whole output).  Fails if the two differ."""
    got, want = run(), plain()
    torch.cuda.synchronize()
    if isinstance(got, tuple):        # K9's conversion: q_pos and q_neg
        got, want = (torch.cat([t.reshape(-1) for t in x])
                     for x in (got, want))
    err = int(((got if part is None else part(got)).long() -
               want.long()).abs().max())
    del want
    nbytes = sum(t.numel() * 4 for t in inputs) + got.numel() * 4
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(prods / INT_PRODUCTS_PER_S, macs / INT8_MACS_PER_S) * 1e3
    ms, timed_by = cuda_ms(run, reps)
    rec = {"max_abs_err": err, "ms": ms, "timed_by": timed_by,
           "plain_ms": cuda_ms(plain, 1, 1)[0],
           "bound_ms": max(mem_ms, ops_ms),
           "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
           "bytes": nbytes, "products": prods, "int8_macs": macs,
           "shape": list(got.shape)}
    print(f"check {name}: max_abs_err={err} (tolerance 0) kernel "
          f"{rec['ms']:.4f} ms ({timed_by}) plain {rec['plain_ms']:.4f} "
          f"ms bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{nbytes} B, {prods} products, {macs} int8 MACs; "
          f"{rec['bound_ms'] / ms:.1%} of it) out {tuple(got.shape)}",
          flush=True)
    if err:
        raise SystemExit(f"{name}: kernel differs from its plain version")
    del got
    torch.cuda.empty_cache()
    return rec


def k9_cases(gen) -> list:
    """Phase 3 cases of K9 at the four benchmark cells' shapes, each held
    to its plain version (server/convert.py scal_to_mat_batch,
    convert_plain): the composition of dim0 256 cts (spiral_20_256, and
    the factored cell's spiral_14_100000), of 1,024 (the SELECTED
    parameters) and of a batch of 8 x 256 (spiral_20_256.batch8); the
    conversion of nu_2 t_gsw 63 (7 x 9), 72 (8 x 9, SELECTED) and 8 x 63,
    against a gadget G2 of random residues."""
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.server import convert

    cases = []
    sp, (_, sel, _) = preset("spiral_20_256"), selected()
    for tag, p, lead in (("256", sp, ()), ("1024", sel, ()),
                         ("b8_256", sp, (BATCH,))):
        d, B = p.poly_len, math.prod(lead)
        cv = rand_residues(gen, lead + (p.dim0, 2, 1, d))
        W = rand_residues(gen, (p.n1, p.n0 * p.m_conv, d))
        cases.append((f"compose_{tag}", "compose",
                      lambda cv=cv, W=W, p=p: convert.compose_cts(cv, W, p),
                      lambda cv=cv, W=W, p=p: convert.scal_to_mat_batch(
                          cv, W, p), 20, [cv, W],
                      k9_products(B * p.dim0, d, False)))
    for p, lead in ((sp, ()), (sel, ()), (sp, (BATCH,))):
        d, B, n = p.poly_len, math.prod(lead), p.further_dims * p.t_gsw
        cv = rand_residues(gen, lead + (n, 2, 1, d))
        W, V = (rand_residues(gen, (p.n1, 2 * p.m_conv, d))
                for _ in range(2))
        g2 = rand_residues(gen, (p.n1, p.m2, d))
        tag = f"{n}" if not lead else f"b{B}_{n}"
        cases.append((f"convert_{tag}", "convert",
                      lambda cv=cv, W=W, V=V, g2=g2, p=p: convert.convert_cts(
                          cv, W, V, g2, p),
                      lambda cv=cv, W=W, V=V, g2=g2, p=p:
                      convert.convert_plain(cv, W, V, g2, p), 20,
                      [cv, W, V, g2], k9_products(B * n, d, True)))
    return cases


def k10_cases() -> list:
    """Phase 3 cases of K10, held to uniform_residues_words_plain: the
    replay of every benchmark cell (one packed ct of d 2,048; B = 1 for
    spiral_20_256.single, the factored and the 30 KB cells, B = 8 for
    spiral_20_256.batch8) and of spiralstream_20_256's 542 direct cts, a
    query and a batch of 8; seeds with negative and int32 edges."""
    from spiral_tpu_torch.core import sampling
    from spiral_tpu_torch.crypto.query import seed_words

    seeds = [0, -1, 2**31 - 1, -(2**31), 987654, -123456789, 7, 1 << 30]
    cases = []
    for n_cts in (1, 542):
        for B in (1, BATCH):
            words = seed_words(seeds[:B], "cuda")
            shape = (n_cts, 1, 1, 2048)
            cases.append((
                f"threefry_b{B}_{n_cts}", "threefry",
                lambda w=words, s=shape: sampling.uniform_residues_words(
                    w, s),
                lambda w=words, s=shape:
                sampling.uniform_residues_words_plain(w, s), 20, [words],
                B * math.prod(shape) * 4 * K10_OPS_PER_HASH))
    return cases


def report_captures(tag: str, server, card: str) -> dict:
    """Print every program `server` captured with the launches one replay
    makes (summed over its graphs) and its pool bytes, and return them.
    Every program that takes the query's seeds (all but the factored
    tail, which starts from the expanded query) records exactly one K10
    launch, or the run fails."""
    recorded, bad = {}, {}
    for key, prog in server.graphs.programs.items():
        launches = collections.Counter()
        for g in prog.graphs:
            launches.update({k: v for k, v in g.launches.items() if v})
        recorded[str(key)] = {
            "graphs": len(prog.graphs), "launches": dict(launches),
            "pool_bytes": sum(g.pool_bytes for g in prog.graphs)}
        if launches["threefry"] != (key[0] != "tail"):
            bad[str(key)] = launches["threefry"]
    print(f"{tag} programs captured (launches a replay, pool bytes): "
          f"{json.dumps(recorded)} [{card}]", flush=True)
    if bad:
        raise SystemExit(f"{tag}: K10 launches a replay {bad}, want one in "
                         f"every program but the factored tail")
    return recorded


def fold_batch_case(gen, tag: str, t: int, m_out: int, per_q_shape):
    """A K5 case at B = BATCH, d 2048: a Spiral round (per_q_shape None;
    n1 3, n2 2) or a pack round (per_q_shape (T, cts)), m_out outputs per
    query."""
    from spiral_tpu_torch.server import fold

    B, d, n1, n2 = BATCH, 2048, 3, 2
    if per_q_shape is None:
        cts = rand_residues(gen, (B, 2 * m_out, n1, n2, d))
        qn, qp = (rand_residues(gen, (B, n1, t * n1, d)) for _ in range(2))
        return (f"fold_batch_{tag}", "fold_batch",
                lambda: fold.fold_round_batch(cts, qn, qp, t),
                lambda: fold.fold_round_plain(cts, qn, qp, t), 5,
                [cts, qn, qp], B * fold_products(m_out, n1, n2, t, d))
    cts = rand_residues(gen, (B,) + per_q_shape + (2, 1, d))
    qn, qp = (rand_residues(gen, (B, 2, 2 * t, d)) for _ in range(2))
    return (f"fold_pack_batch_{tag}", "fold_pack_batch",
            lambda: fold.fold_pack_round_batch(cts, qn, qp, t),
            lambda: fold.fold_pack_round_plain(cts, qn, qp, t), 5,
            [cts, qn, qp], B * fold_products(m_out, 2, 1, t, d))


def pack_case(gen, tag: str, lead: tuple, out_n: int, m_conv: int):
    """A K7 case: `lead` queries (() for one) of out_n^2 result cts packed
    with keys of m_conv digits."""
    from spiral_tpu_torch.server import pack

    d, B = 2048, math.prod(lead)
    rcts = rand_residues(gen, lead + (out_n * out_n, 2, 1, d))
    v_W = rand_residues(gen, (out_n, out_n + 1, m_conv, d))
    return (f"{tag}_n{out_n}_m{m_conv}", "pack",
            lambda: pack.pack_ciphertexts(rcts, v_W),
            lambda: pack.pack_ciphertexts_plain(rcts, v_W), 20, [rcts, v_W],
            B * out_n * 2 * out_n * (m_conv * (ntt_products(d) +
                                               (out_n + 1) * d) +
                                     ntt_products(d)))


def firstdim_cases(gen, tag: str, K: int, m: int, rows: int,
                   batches: tuple) -> list:
    """K2 cases on one database of K x m (2, d, K, m), each B of `batches`
    queries of `rows` rows; B = 1 runs the single-query entry point."""
    from spiral_tpu_torch.server import firstdim

    d = 2048
    db = rand_residues(gen, (d, K, m), 0)
    cases = []
    for qb in batches:
        qk = rand_residues(gen, (qb, K, rows, d))
        if qb == 1:
            run = lambda qk=qk: firstdim.multiply_query_by_db(db, qk[0])
            plain = lambda qk=qk: firstdim.multiply_plain(db, qk[0])
            name = f"firstdim_{tag}"
        else:
            run = lambda qk=qk: firstdim.multiply_query_by_db_batch(db, qk)
            plain = lambda qk=qk: firstdim.multiply_batch_plain(db, qk)
            name = f"firstdim_batch_{tag}" + (f"_b{qb}" if qb != BATCH
                                              else "")
        cases.append((name, "firstdim", run, plain, 5, [db, qk], 0,
                      K2_MACS_PER_PRODUCT * 2 * d * K * m * qb * rows))
    return cases


def stream_cases(gen) -> list:
    """Phase 3 cases at the stream presets' shapes and digit widths: K3 at
    spiralstream_20_256's round 1 (t_gsw 5, 12-bit signed digits, m_out
    32) and K5 there at B = 8; K6 at spiralstreampack_20_256's round 1
    (t_gsw 3, 19-bit unsigned digits, 512 outputs) and K5's pack form
    there at B = 8; K7 at out_n 4 and m_conv 56 (1-bit digits), one query
    and B = 8; K2 on both stream databases (K 1,024, n1 3, m 128: 2 GiB;
    K 64, n1 2, m 1,024: 1 GiB) at B = 1 and 8."""
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.server import fold

    ss, sp = preset("spiralstream_20_256"), preset("spiralstreampack_20_256")
    d, n1, n2, t = ss.poly_len, ss.n1, ss.n2, ss.t_gsw
    cts = rand_residues(gen, (ss.num_per, n1, n2, d))
    qn, qp = (rand_residues(gen, (n1, t * n1, d)) for _ in range(2))
    cases = [(f"fold_t{t}", "fold", lambda: fold.fold_round(cts, qn, qp, t),
              lambda: fold.fold_round_plain(cts, qn, qp, t), 5,
              [cts, qn, qp], fold_products(ss.num_per // 2, n1, n2, t, d)),
             fold_batch_case(gen, f"t{t}", t, ss.num_per // 2, None)]
    T, tp = sp.out_n ** 2, sp.t_gsw
    pcts = rand_residues(gen, (T, sp.num_per, 2, 1, d))
    pn, pq = (rand_residues(gen, (2, 2 * tp, d)) for _ in range(2))
    cases += [(f"fold_pack_t{tp}", "fold_pack",
               lambda: fold.fold_pack_round(pcts, pn, pq, tp),
               lambda: fold.fold_pack_round_plain(pcts, pn, pq, tp), 5,
               [pcts, pn, pq], fold_products(T * sp.num_per // 2, 2, 1, tp,
                                             d)),
              fold_batch_case(gen, f"t{tp}", tp, T * sp.num_per // 2,
                              (T, sp.num_per)),
              pack_case(gen, "pack", (), sp.out_n, sp.m_conv),
              pack_case(gen, "pack_batch", (BATCH,), sp.out_n, sp.m_conv)]
    cases += firstdim_cases(gen, "stream", ss.dim0 * ss.n0,
                            ss.num_per * n2, n1, (1, BATCH))
    cases += firstdim_cases(gen, "stream_pack", sp.dim0, T * sp.num_per, 2,
                            (1, BATCH))
    return cases


def batch_cases(gen) -> list:
    """Phase 3 cases of the batch and implicit paths: K5 at round 1 (and
    the last round) of both forms at B = 8, K2 over B = 8 queries at both
    paths' shapes and chunked over the spiral_24_256 slab, K1 on a batch's
    first-dim output, K7 over a batch, and spiral_24_256's new widths (K3
    and K5 at t_gsw 11, K4 at m 16)."""
    from spiral_tpu_torch.arith import ntt
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.server import expand, firstdim, fold
    from spiral_tpu_torch.server.db import slab_rows

    cases = []
    sp, pp, big = (preset(n) for n in ("spiral_20_256", "spiralpack_20_256",
                                       "spiral_24_256"))
    d, n1, n2 = sp.poly_len, sp.n1, sp.n2
    B, T = BATCH, pp.out_n ** 2

    # K5, round 1 of both forms, both digit widths; the last Spiral round
    for name in ("spiral_20_256", "spiral_20_256_paper"):
        t = preset(name).t_gsw
        cases.append(fold_batch_case(gen, f"t{t}", t, sp.num_per // 2, None))
    cases.append(fold_batch_case(gen, f"t{sp.t_gsw}_last", sp.t_gsw, 1, None))
    for name in ("spiralpack_20_256", "spiralpack_20_256_paper"):
        t = preset(name).t_gsw
        cases.append(fold_batch_case(gen, f"t{t}", t, T * pp.num_per // 2,
                               (T, pp.num_per)))
    # K2 over B queries: G = 24 rows (Spiral) and 16 (pack); the Spiral
    # database also at B = 2, 3, 4 and 16, around the rule that picks K2's
    # form from the query rows (csrc/firstdim.cu)
    cases += firstdim_cases(gen, "spiral", sp.dim0 * sp.n0, sp.num_per * n2,
                            n1, (B, 2, 3, 4, 16))
    cases += firstdim_cases(gen, "pack", pp.dim0, T * pp.num_per, 2, (B,))
    # K2 chunked over the spiral_24_256 slab (64 rows x n2, 2 GiB), two
    # chunks, one query and B; each chunk streams the slab from device
    # memory, as a database of num_chunks slabs would, so its bytes count
    # once per chunk
    K24 = big.dim0 * big.n0
    m24 = slab_rows(big.num_per, n2 * K24 * 2 * d * 4, 2 << 30) * n2
    slab = rand_residues(gen, (d, K24, m24), 0)
    for qb in (1, B):
        qk = rand_residues(gen, (qb, K24, n1, d))
        cases.append((f"firstdim_implicit_b{qb}_2chunks", "firstdim",
                      lambda qk=qk: firstdim.multiply_query_by_db_batch(
                          slab, qk, 2),
                      lambda qk=qk: firstdim.multiply_batch_plain(
                          slab, qk, 2), 5, [slab, slab, qk], 0,
                      K2_MACS_PER_PRODUCT * 2 * 2 * d * K24 * m24 * qb * n1))
    # K1 on the first-dim output of a Spiral batch
    x = rand_residues(gen, (B * sp.num_per * n1 * n2, d))
    cases.append(("ntt_inverse_batch", "ntt", lambda: ntt.inverse(x),
                  lambda: ntt.inverse_plain(x), 20, [x],
                  x.numel() // d * ntt_products(d)))
    # K7 over a batch of pack results
    cases.append(pack_case(gen, "pack_batch", (B,), pp.out_n, pp.m_conv))
    # spiral_24_256: K3 at t_gsw 11 (6-bit digits), its round 1; K5 at t 11
    # at round 5 of a batch (64 outputs per query); K4 at m 16, its largest
    # left round
    t = big.t_gsw
    cts = rand_residues(gen, (big.num_per, n1, n2, d))
    qn, qp = (rand_residues(gen, (n1, t * n1, d)) for _ in range(2))
    cases.append((f"fold_t{t}", "fold",
                  lambda: fold.fold_round(cts, qn, qp, t),
                  lambda: fold.fold_round_plain(cts, qn, qp, t), 5,
                  [cts, qn, qp], fold_products(big.num_per // 2, n1, n2, t,
                                               d)))
    cases.append(fold_batch_case(gen, f"t{t}_round5", t, 64, None))
    mk, N = big.m_exp, 1 << (big.g - 1)
    cv, ca = (rand_residues(gen, (N, 2, 1, d)) for _ in range(2))
    W = rand_residues(gen, (2, mk, d))
    cases.append((f"expand_m{mk}", "expand",
                  lambda: expand.keyswitch(cv, ca, W, mk),
                  lambda: expand.keyswitch_plain(cv, ca, W, mk), 5,
                  [cv, ca, W], expand_products(N, mk, d)))
    return cases


def mxu_cases(gen) -> list:
    """Phase 3 cases of K8a and K8b: K8a at spiral_20_256's expansion
    round 0 (2 cts, t = d + 1) and its largest round (r = 8, past the
    stopround: the 256 even cts, t = 9), that round also for a batch of
    BATCH queries; K8b-1 and K8b-2 at fold round 1 (m_out 64) at t_gsw 9
    and 8, at the last round (m_out 1), and at spiral_24_256's round 1
    (t_gsw 11, m_out 1,024: G is 2.2 GB); K8b-2 at round 1 (t_gsw 9) on
    p - 1 in every word of G and q, its largest limb sums."""
    from spiral_tpu_torch.params import B_I, P_I, preset
    from spiral_tpu_torch.server import expand, fold

    sp, big = preset("spiral_20_256"), preset("spiral_24_256")
    d, n1, n2 = sp.poly_len, sp.n1, sp.n2
    cases = []
    for tag, r, shape in (("r0", 0, (2,)), (f"r{sp.g - 1}", sp.g - 1,
                                            (1 << (sp.g - 1),)),
                          (f"r{sp.g - 1}_b{BATCH}", sp.g - 1,
                           (BATCH, 1 << (sp.g - 1)))):
        t = (d >> r) + 1
        x = rand_residues(gen, shape + (2, 1, d))
        cases.append((f"auto_{tag}", "auto",
                      lambda x=x, t=t: expand.inv_ntt_automorph(x, t),
                      lambda x=x, t=t: expand.inv_ntt_automorph_plain(x, t),
                      20, [x], x.numel() // d * ntt_products(d)))
    for tag, t, m_out in ((f"t{sp.t_gsw}", sp.t_gsw, sp.num_per // 2),
                          ("t8", preset("spiral_20_256_paper").t_gsw,
                           sp.num_per // 2),
                          (f"t{sp.t_gsw}_last", sp.t_gsw, 1),
                          (f"t{big.t_gsw}", big.t_gsw, big.num_per // 2)):
        pairs = rand_residues(gen, (m_out, 2, n1, n2, d))
        G = rand_residues(gen, (2, t, m_out, n1 * n2, d), 0)
        qn, qp = (rand_residues(gen, (n1, t * n1, d)) for _ in range(2))
        cases.append((f"fold_ntt_{tag}", "fold_ntt",
                      lambda pairs=pairs, t=t: fold.fold_ntt(pairs, t),
                      lambda pairs=pairs, t=t: fold.fold_ntt_plain(pairs, t),
                      5, [pairs], m_out * 2 * n1 * n2 * 2 * t *
                      ntt_products(d)))
        # M = 4 i-limbs x n1 rows, K = 2 s x t k x n1 x 4 j-limbs, N =
        # m_out x n2, one GEMM per (limb, slot)
        cases.append((f"fold_contract_{tag}", "fold_contract",
                      lambda G=G, qn=qn, qp=qp, t=t: fold.fold_contract(
                          G, qn, qp, t),
                      lambda G=G, qn=qn, qp=qp, t=t: fold.fold_contract_plain(
                          G, qn, qp, t), 5, [G, qn, qp], 0,
                      2 * d * (4 * n1) * (8 * t * n1) * (m_out * n2)))
    t, m_out = sp.t_gsw, sp.num_per // 2
    G = torch.empty((2, 2, t, m_out, n1 * n2, d), dtype=torch.int32,
                    device="cuda")
    qn, qp = (torch.empty((n1, t * n1, 2, d), dtype=torch.int32,
                          device="cuda") for _ in range(2))
    for x, limb in ((G[0], 0), (G[1], 1), (qn[..., 0, :], 0),
                    (qn[..., 1, :], 1), (qp[..., 0, :], 0),
                    (qp[..., 1, :], 1)):
        x.fill_((P_I, B_I)[limb] - 1)
    cases.append((f"fold_contract_t{t}_worst", "fold_contract",
                  lambda: fold.fold_contract(G, qn, qp, t),
                  lambda: fold.fold_contract_plain(G, qn, qp, t), 5,
                  [G, qn, qp], 0,
                  2 * d * (4 * n1) * (8 * t * n1) * (m_out * n2)))
    return cases


def edge_cases(gen) -> list:
    """Phase 3 cases at the edges of the cluster designs of K3, K4 and K6:
    K4 at one ct with m 56 (a lone cluster); K3 and K6 at m_out 1 (one
    cluster per column and limb) and m_out 5, each at t_gsw 8, 9 and 11
    (an odd digit count leaves a block's last step one poly short)."""
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.server import expand, fold

    sp = preset("spiral_20_256")
    d, n1, n2, mk = sp.poly_len, sp.n1, sp.n2, sp.m_exp_right
    cv, ca = (rand_residues(gen, (1, 2, 1, d)) for _ in range(2))
    W = rand_residues(gen, (2, mk, d))
    cases = [(f"expand_m{mk}_n1", "expand",
              lambda: expand.keyswitch(cv, ca, W, mk),
              lambda: expand.keyswitch_plain(cv, ca, W, mk), 20, [cv, ca, W],
              expand_products(1, mk, d))]
    for t in (8, 9, 11):
        for m_out in (1, 5):
            cts = rand_residues(gen, (2 * m_out, n1, n2, d))
            qn, qp = (rand_residues(gen, (n1, t * n1, d)) for _ in range(2))
            cases.append((f"fold_t{t}_m{m_out}", "fold",
                          lambda cts=cts, qn=qn, qp=qp, t=t: fold.fold_round(
                              cts, qn, qp, t),
                          lambda cts=cts, qn=qn, qp=qp, t=t:
                          fold.fold_round_plain(cts, qn, qp, t), 20,
                          [cts, qn, qp], fold_products(m_out, n1, n2, t, d)))
            pcts = rand_residues(gen, (1, 2 * m_out, 2, 1, d))
            pn, pq = (rand_residues(gen, (2, 2 * t, d)) for _ in range(2))
            cases.append((f"fold_pack_t{t}_m{m_out}", "fold_pack",
                          lambda c=pcts, qn=pn, qp=pq, t=t:
                          fold.fold_pack_round(c, qn, qp, t),
                          lambda c=pcts, qn=pn, qp=pq, t=t:
                          fold.fold_pack_round_plain(c, qn, qp, t), 20,
                          [pcts, pn, pq], fold_products(m_out, 2, 1, t, d)))
    return cases


def as_params(p):
    """A preset's Params by name, or `p` itself."""
    from spiral_tpu_torch.params import preset
    return preset(p) if isinstance(p, str) else p


def selected() -> tuple[str, object, int]:
    """(tag, Params, factor) of select_params(*SELECTED)."""
    from spiral_tpu_torch.paramgen.search import select_params
    sel = select_params(*SELECTED)
    return f"spiral_{SELECTED[0]}_{SELECTED[1]}", sel.params, sel.factor


def expand_launches(p) -> list[tuple[str, int, int, int]]:
    """The K4 launches of one query at a preset (by name) or a Params, in
    the order coefficient_expansion makes them: (side, round, cts N,
    digits m).  Odd slots stop after the stopround, where only the first
    t_gsw * nu_2 + 1 are switched."""
    p = as_params(p)
    out = []
    for r in range(p.g):
        out.append(("even", r, 1 << r, p.m_exp))
        if p.stopround == 0 or r <= p.stopround:
            n = 1 << r
            if p.stopround > 0 and r == p.stopround:
                n = min(n, p.t_gsw * p.further_dims + 1)
            out.append(("odd", r, n, p.m_exp_right))
    return out


def time_expand_launches(gen) -> dict:
    """Phase 3b: K4 at each launch of one query's expansion at
    spiral_20_256, spiral_24_256 and the SELECTED parameters
    (expand_launches), each held bit-equal to keyswitch_plain and timed as
    cuda_ms does, beside its bound; the sum over a query's launches per
    parameter set."""
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.server import expand

    out = {}
    for name, p in (("spiral_20_256", preset("spiral_20_256")),
                    ("spiral_24_256", preset("spiral_24_256")),
                    selected()[:2]):
        d = p.poly_len
        rows, total, bound = [], 0.0, 0.0
        for side, r, N, m in expand_launches(p):
            cv, ca = (rand_residues(gen, (N, 2, 1, d)) for _ in range(2))
            W = rand_residues(gen, (2, m, d))
            got = expand.keyswitch(cv, ca, W, m)
            err = int((got.long() - expand.keyswitch_plain(
                cv, ca, W, m).long()).abs().max())
            ms, timed_by = cuda_ms(lambda: expand.keyswitch(cv, ca, W, m), 20)
            nbytes = (cv.numel() + ca.numel() + W.numel() + got.numel()) * 4
            b_ms = max(nbytes / HBM_BYTES_PER_S,
                       expand_products(N, m, d) / INT_PRODUCTS_PER_S) * 1e3
            total, bound = total + ms, bound + b_ms
            rows.append({"side": side, "round": r, "N": N, "m": m, "ms": ms,
                         "timed_by": timed_by, "bound_ms": b_ms,
                         "max_abs_err": err})
            print(f"expand {name} {side} round {r} (N {N}, m {m}): "
                  f"max_abs_err={err} (tolerance 0) kernel {ms:.4f} ms "
                  f"({timed_by}) bound {b_ms:.4f} ms", flush=True)
            if err:
                raise SystemExit(f"expand {name} {side} round {r}: kernel "
                                 f"differs from keyswitch_plain")
        print(f"expand {name}: {len(rows)} launches per query, sum "
              f"{total:.4f} ms (bound {bound:.4f} ms)", flush=True)
        out[name] = {"launches": rows, "sum_ms": total, "sum_bound_ms": bound}
    return out


def k1_launches(name: str) -> list[tuple[str, str, int]]:
    """The K1 launches of one query at a Spiral preset, in the order
    process_query makes them, the expansion's constants being made once
    per server: (stage, direction, polys per limb); the fold rounds that
    run K8b close with a K1 inverse each."""
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.server import fold
    p = preset(name)
    outs = [p.num_per >> (r + 1) for r in range(p.nu_2)]
    return [("query a", "forward", 1),
            ("first dim", "inverse", p.num_per * p.n1 * p.n2)] + \
        [(f"fold round {r + 1}", "inverse", m_out * p.n1 * p.n2)
         for r, m_out in enumerate(outs)
         if fold.round_uses_mxu(m_out, p.n1, p.n2, p.t_gsw)]


def auto_launches(p) -> list[tuple[int, int, int]]:
    """The K8a launches of one query at a Spiral preset (by name) or a
    Params: (round, t, cts), every ct of the round while odd slots live,
    the evens after the stopround."""
    p = as_params(p)
    return [(r, (p.poly_len >> r) + 1,
             2 << r if p.stopround == 0 or r <= p.stopround else 1 << r)
            for r in range(p.g)]


def time_ntt_auto_launches(gen) -> dict:
    """Phase 3c: K1 at each of its launches in one spiral_20_256 query
    (k1_launches) and K8a at each of its rounds (auto_launches) there and
    at the SELECTED parameters, each held bit-equal to its plain version
    on inputs made on the card and timed as cuda_ms does, beside its
    bound; the sums per query, {kernel: {parameter set: ...}}."""
    from spiral_tpu_torch.arith import ntt
    from spiral_tpu_torch.server import expand

    def autos(p):
        return [(f"round {r} (t {t})", 2 * n,
                 lambda x, t=t: expand.inv_ntt_automorph(x, t),
                 lambda x, t=t: expand.inv_ntt_automorph_plain(x, t))
                for r, t, n in auto_launches(p)]

    sp = as_params("spiral_20_256")
    sel_tag, sel, _ = selected()
    out = {}
    cases = (("ntt", "spiral_20_256", sp,
              [(f"{stage} {way}", n, getattr(ntt, way),
                getattr(ntt, way + "_plain"))
               for stage, way, n in k1_launches("spiral_20_256")]),
             ("auto", "spiral_20_256", sp, autos(sp)),
             ("auto", sel_tag, sel, autos(sel)))
    for kernel, name, p, launches in cases:
        d = p.poly_len
        rows, total, bound = [], 0.0, 0.0
        for tag, n, run, plain in launches:
            x = rand_residues(gen, (n, d))
            err = int((run(x).long() - plain(x).long()).abs().max())
            ms, timed_by = cuda_ms(lambda: run(x), 20)
            b_ms = max(2 * x.numel() * 4 / HBM_BYTES_PER_S,
                       2 * n * ntt_products(d) / INT_PRODUCTS_PER_S) * 1e3
            total, bound = total + ms, bound + b_ms
            rows.append({"launch": tag, "polys": 2 * n, "ms": ms,
                         "timed_by": timed_by, "bound_ms": b_ms,
                         "max_abs_err": err})
            print(f"{kernel} {name} {tag} ({n} x 2 polys): max_abs_err="
                  f"{err} (tolerance 0) kernel {ms:.4f} ms ({timed_by}) "
                  f"bound {b_ms:.4f} ms", flush=True)
            if err:
                raise SystemExit(f"{kernel} {name} {tag}: kernel differs "
                                 f"from its plain version")
        print(f"{kernel} {name}: {len(rows)} launches per query, sum "
              f"{total:.4f} ms (bound {bound:.4f} ms)", flush=True)
        out.setdefault(kernel, {})[name] = {
            "launches": rows, "sum_ms": total, "sum_bound_ms": bound}
    return out


def check_selected(gen) -> dict:
    """Phase 3d: K3 at each fold round of the SELECTED parameters (their
    factor x num_per first-dim cts fold as one axis) and K2 over their
    whole encoded layout, random residues made on the card: K2 timed on
    the whole layout beside its bound, and held to the plain multiply on
    its first SELECTED_K2_COLS columns (the whole reduction axis K).
    Returns {kernel: {case: record}}."""
    from spiral_tpu_torch.params import B_I, P_I
    from spiral_tpu_torch.server import firstdim, fold

    tag, p, factor = selected()
    d, n1, n2, t = p.poly_len, p.n1, p.n2, p.t_gsw
    out = {"fold": {}, "firstdim": {}}
    for r in range(p.nu_2):
        m_out = factor * p.num_per >> (r + 1)
        cts = rand_residues(gen, (2 * m_out, n1, n2, d))
        qn, qp = (rand_residues(gen, (n1, t * n1, d)) for _ in range(2))
        name = f"fold_{tag}_round{r + 1}"
        out["fold"][name] = check_case(
            name, "fold", lambda: fold.fold_round(cts, qn, qp, t),
            lambda: fold.fold_round_plain(cts, qn, qp, t), 5,
            [cts, qn, qp], fold_products(m_out, n1, n2, t, d))
    del cts, qn, qp
    K, m = p.dim0 * p.n0, factor * p.num_per * p.n2
    db = torch.empty((2, d, K, m), dtype=torch.int32, device="cuda")
    for limb, modulus in enumerate((P_I, B_I)):
        db[limb].random_(0, modulus, generator=gen)
    qk = rand_residues(gen, (K, n1, d))
    cols = slice(0, SELECTED_K2_COLS)
    name = f"firstdim_{tag}"
    out["firstdim"][name] = check_case(
        name, "firstdim", lambda: firstdim.multiply_query_by_db(db, qk),
        lambda: firstdim.multiply_plain(db[..., cols], qk), 5, [db, qk], 0,
        K2_MACS_PER_PRODUCT * 2 * d * K * m * n1,
        part=lambda got: got[..., cols])
    del db
    torch.cuda.empty_cache()
    return out


def compare_fold_rounds(gen) -> dict:
    """Every fold round of spiral_20_256 (t_gsw 9) and spiral_24_256 (t_gsw
    11), and round 1 at t_gsw 8, as K3 and as a K8b round (K8b-1, K8b-2
    and K1's inverse) on the same inputs: bit equality, then both timed in
    turns (K3, K8b, K8b, K3), beside the engine fold_rounds picks for the
    round (fold.round_uses_mxu).  Per preset, the sums over its rounds of
    K3's, K8b's and the picked engine's times."""
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.server import fold

    out = {}
    for name, last in (("spiral_20_256", None), ("spiral_24_256", None),
                       ("spiral_20_256_paper", 1)):
        p = preset(name)
        t, d, n1, n2 = p.t_gsw, p.poly_len, p.n1, p.n2
        rounds, sums = [], {"k3": 0.0, "mxu": 0.0, "picked": 0.0}
        for r in range(p.nu_2 if last is None else last):
            m_out = p.num_per >> (r + 1)
            cts = rand_residues(gen, (2 * m_out, n1, n2, d))
            qn, qp = (rand_residues(gen, (n1, t * n1, d)) for _ in range(2))

            def mxu(cts=cts, qn=qn, qp=qp):
                return fold.fold_round_mxu(cts, qn, qp, t)

            def k3(cts=cts, qn=qn, qp=qp):
                return fold.fold_round(cts, qn, qp, t)

            same = torch.equal(mxu(), k3())
            ms = [cuda_ms(f, 5) for f in (k3, mxu, mxu, k3)]
            k3_ms = (ms[0][0] + ms[3][0]) / 2
            mxu_ms = (ms[1][0] + ms[2][0]) / 2
            picked = "K8b" if fold.round_uses_mxu(m_out, n1, n2, t) \
                else "K3"
            sums["k3"] += k3_ms
            sums["mxu"] += mxu_ms
            sums["picked"] += mxu_ms if picked == "K8b" else k3_ms
            rounds.append({"round": r + 1, "m_out": m_out, "equal": same,
                           "k3_ms": [ms[0][0], ms[3][0]],
                           "mxu_ms": [ms[1][0], ms[2][0]],
                           "timed_by": [m[1] for m in ms], "picked": picked})
            print(f"fold {name} t{t} round {r + 1} (m_out {m_out}, K3 "
                  f"{2 * m_out * n2} blocks): K8b round (K8b-1 + K8b-2 + K1) "
                  f"{ms[1][0]:.4f} / {ms[2][0]:.4f} ms vs K3 {ms[0][0]:.4f} "
                  f"/ {ms[3][0]:.4f} ms (in turns K3, K8b, K8b, K3; "
                  f"{', '.join(m[1] for m in ms)}), picked {picked}, "
                  f"outputs equal: {same}", flush=True)
            if not same:
                raise SystemExit(f"{name} round {r + 1}: the K8b round "
                                 f"differs from K3's")
            del cts, qn, qp
            torch.cuda.empty_cache()
        print(f"fold {name} t{t} over {len(rounds)} rounds: K3 "
              f"{sums['k3']:.4f} ms, K8b {sums['mxu']:.4f} ms, the picked "
              f"engines {sums['picked']:.4f} ms", flush=True)
        out[f"{name}_t{t}"] = {"rounds": rounds, "sum_ms": sums}
    return out


def library_probe() -> dict:
    """Whether PyTorch has a batched int8 GEMM on CUDA (K8b-2's library
    yardstick): each call's result or its error."""
    x = torch.ones((4, 32, 32), dtype=torch.int8, device="cuda")
    out = {}
    for name, f in (("torch.bmm int8", lambda: torch.bmm(x, x)),
                    ("torch._int_mm 3-D", lambda: torch._int_mm(x, x))):
        try:
            f()
            torch.cuda.synchronize()
            out[name] = "works"
        except (RuntimeError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    print(f"library probe: {out}", flush=True)
    return out


def _variant(pack: bool):
    """(client class, server class, random db, encode db) of a variant."""
    from spiral_tpu_torch import pack as pk
    from spiral_tpu_torch import pir
    from spiral_tpu_torch.server import db
    if pack:
        return pk.PackClient, pk.PackServer, pk.random_pack_db, \
            pk.encode_pack_db
    return pir.SpiralClient, pir.SpiralServer, db.random_db, db.encode_db


def check_tiny(name: str, seed: int, pack: bool, must: tuple = ()) -> None:
    """The whole flow at a tiny preset on the card equals the plain CPU
    flow, response row for response row; the card's run must launch each
    kernel of `must`."""
    from spiral_tpu_torch import interop, kernels
    from spiral_tpu_torch.params import preset

    p = preset(name)
    Client, Server, random_db, encode = _variant(pack)
    rows = []
    for dev in ("cpu", "cuda"):
        kernels.reset_launches()
        client = Client(p, seed=seed, device=dev)
        pts = random_db(p, np.random.default_rng(seed))
        server = Server(p, encode(pts, p, torch.device(dev)), client.setup())
        resp, _ = server.process_query(client.query(p.total_n - 1))
        if not np.array_equal(client.decode(resp),
                              pts[p.total_n - 1].astype(object)):
            raise SystemExit(f"{name} on {dev}: wrong record")
        rows.append(interop.response_rows(resp))
    same = all(np.array_equal(a, b) for a, b in zip(*rows))
    print(f"{name}: cuda response rows equal the plain cpu rows: {same}; "
          f"launches on the card {dict(kernels.LAUNCHES)}", flush=True)
    if not same:
        raise SystemExit(f"{name}: cuda and cpu responses differ")
    if not all(kernels.LAUNCHES[k] for k in must):
        raise SystemExit(f"{name}: a kernel of {must} was never launched")


def same_rows(a, b) -> bool:
    from spiral_tpu_torch import interop
    return all(np.array_equal(x, y) for x, y in
               zip(interop.response_rows(a), interop.response_rows(b)))


def report_batch(tag: str, server, n: int, seconds: float, db_bytes: int,
                 launches: dict, path: tuple, card: str) -> None:
    """Print a batch's time, rate, stage times and launches; fail if a
    kernel of `path` was never launched."""
    tm = server.last_timings
    stages = {k: round(v, 1) for k, v in vars(tm).items()}
    print(f"{tag}: B={n} batch {seconds * 1e3:.3f} ms (host clock, until "
          f"the rows are on the host) = {seconds * 1e3 / n:.3f} ms per "
          f"query, aggregate {n * db_bytes / seconds / 1e6:.1f} MB/s; "
          f"stages by cuda events {tm.total_us / 1e3:.3f} ms "
          f"stages_us={stages} launches per batch={launches} [{card}]",
          flush=True)
    if not all(launches[k] for k in path):
        raise SystemExit(f"{tag}: a kernel of the path was never launched")


def capture_chain(tag: str, server, query, card: str) -> dict:
    """The first process_query of `query`'s form on a fresh server: its
    eager warm run and the capture of its stage chain (graphs.py, one
    graph per stage), so that the later queries' launch lines count one
    replay each.  Prints and returns the chain's stats; fails unless it
    holds one graph per stage of the server."""
    server.process_query(query)
    return chain_stats(tag, server, query.packed_b is None, card)


def chain_stats(tag: str, server, direct: bool, card: str) -> dict:
    """Print and return the stats of `server`'s stage chain for the form
    `direct`, captured; fails unless it holds one graph per stage."""
    stats = server.graphs.stats()[("stages", direct, 1)]
    print(f"{tag} stage chain: {stats['graphs']} graphs ({server.stages}) "
          f"captured on the first process_query: warm run "
          f"{stats['warm_s']:.3f} s, capture {stats['capture_s']:.3f} s, "
          f"pool +{stats['pool_bytes'] / 2**20:.1f} MiB [{card}]",
          flush=True)
    if stats["graphs"] != len(server.stages):
        raise SystemExit(f"{tag}: {stats['graphs']} stage graphs for "
                         f"{len(server.stages)} stages")
    return {"stages_warm_s": stats["warm_s"],
            "stages_capture_s": stats["capture_s"],
            "stages_pool_bytes": stats["pool_bytes"]}


def run_fold_forced(tag: str, server, answered: list, card: str,
                    decode=None) -> tuple[dict, dict]:
    """Serve queries again with the fold's engine forced in every round
    (FOLD_FORCED): each response's rows must equal the default server's
    (`answered`: (idx, query, default response)) and, where `decode` =
    (client, records) is given, decode to its record.  Prints stage times
    and launches per query, and fails if a forced run launched a kernel it
    must not, or missed one it must.  The server's graphs are released
    before and after each forced run: a graph replays the engine its
    capture saw.  Returns the launches of each forced run and those of its
    last query."""
    from spiral_tpu_torch import kernels
    from spiral_tpu_torch.server import fold

    rule = fold.MXU_MIN_COLS
    launches, per_query = {}, {}
    for forced, forced_rule, must, must_not in FOLD_FORCED:
        ftag = f"{tag} fold {forced}"
        fold.MXU_MIN_COLS = forced_rule
        server.release_graphs()
        try:
            kernels.reset_launches()
            for idx, q, want in answered:
                before = dict(kernels.LAUNCHES)
                resp, tm = server.process_query(q)
                pq = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
                same = same_rows(resp, want)
                ok = decode is None or np.array_equal(
                    decode[0].decode(resp), decode[1][idx].astype(object))
                stages = {k: round(v, 1) for k, v in vars(tm).items()}
                print(f"{ftag} query idx={idx}: rows equal the default "
                      f"server's={same}" +
                      ("" if decode is None else f" correct={ok}") +
                      f" server {tm.total_us / 1e3:.3f} ms (stage graphs) "
                      f"stages_us={stages} launches={pq} [{card}]",
                      flush=True)
                if not (same and ok):
                    raise SystemExit(f"{ftag} query {idx}: rows equal to the "
                                     f"default server's={same}, decodes={ok}")
        finally:
            fold.MXU_MIN_COLS = rule
            server.release_graphs()
        launches[ftag], per_query[ftag] = dict(kernels.LAUNCHES), pq
        if not all(launches[ftag][k] for k in must) or \
                any(launches[ftag][k] for k in must_not):
            raise SystemExit(f"{ftag}: launched {launches[ftag]}")
    return launches, per_query


def run_path(name: str, seed: int, card: str, pack: bool, path: tuple,
             batch_path: tuple, path_not: tuple = ()) -> tuple[dict, dict]:
    """End to end at a full-size preset on the card: a database from numpy
    seed `seed`, a seeded client and three queries, each decoded against
    its record; then a batch of BATCH queries (indices 0, total_n - 1 and
    random ones), each decoded and equal to its single-query rows; then,
    for Spiral, the three queries with the fold forced to one engine
    (run_fold_forced).  Returns ({path: launches}, {path: launches of its
    last query}): the single run's launches count database encode and
    client setup too and must be nonzero for every kernel of `path`, and
    the batch's for every kernel of `batch_path`, and both zero for every
    kernel of `path_not`."""
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
    chain = capture_chain(name, server, client.query(1), card)

    idxs = [0, params.total_n - 1, int(rng.integers(0, params.total_n))]
    db_bytes = pts.size * int(np.log2(params.p_db)) // 8
    answered = []
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
              f"{tm.total_us / 1e3:.3f} ms (stage graphs; host wall "
              f"{wall * 1e3:.1f} ms) "
              f"{db_bytes / tm.total_us:.1f} MB/s stages_us={stages} "
              f"launches={per_query} [{card}]", flush=True)
        if not ok:
            raise SystemExit(f"{name} query {idx} decoded to the wrong "
                             f"record")
        if not pack and (per_query["ntt"] != len(k1_launches(name)) or
                         per_query["compose"] != 1 or
                         per_query["convert"] != 1):
            raise SystemExit(f"{name} query {idx}: {per_query['ntt']} K1 "
                             f"launches, phase 3c lists "
                             f"{len(k1_launches(name))}; K9 "
                             f"{per_query['compose']} compose, "
                             f"{per_query['convert']} convert, want 1 each")
        answered.append((idx, q, resp))
    launches = dict(kernels.LAUNCHES)
    print(f"{name} launches over the path: {launches}", flush=True)
    if not all(launches[k] for k in path) or \
            any(launches[k] for k in path_not):
        raise SystemExit(f"{name}: a kernel of the path was never "
                         f"launched, or one of {path_not} was")
    fd_ms = tm.first_multiply_us / 1e3
    print(f"{name} first-dim stage streams {db.data.numel() * 4 / 2**30:.2f} "
          f"GiB of encoded db in {fd_ms:.3f} ms (incl. inverse NTT): "
          f"{db.data.numel() * 4 / fd_ms / 1e9:.3f} TB/s of 3.35", flush=True)

    bidx = [0, params.total_n - 1] + [
        int(i) for i in rng.integers(0, params.total_n, BATCH - 2)]
    qs = [client.query(i) for i in bidx]
    torch.cuda.synchronize()
    kernels.reset_launches()
    resps, seconds = server.process_query_batch(qs)
    batch = dict(kernels.LAUNCHES)
    report_batch(f"{name} batch", server, len(qs), seconds, db_bytes, batch,
                 batch_path, card)
    if any(batch[k] for k in path_not):
        raise SystemExit(f"{name} batch: launched one of {path_not}")
    for idx, q, r in zip(bidx, qs, resps):
        ok = np.array_equal(client.decode(r), pts[idx].astype(object))
        same = same_rows(r, server.process_query(q)[0])
        if not (ok and same):
            raise SystemExit(f"{name} batch idx={idx}: decodes={ok}, rows "
                             f"equal to its single query's={same}")
    print(f"{name} batch: all {len(qs)} answers decode to their records "
          f"and equal their single-query rows (indices {bidx})", flush=True)
    GRAPHS[name] = check_graph_serving(
        name, server, qs, lambda i, rows: np.array_equal(
            client.decode(server._response(*rows)),
            pts[bidx[i]].astype(object)), card)
    GRAPHS[name].update(chain)
    paths, per_q = {name: launches, f"{name} batch": batch}, \
        {name: per_query}
    if not pack:
        check_k9_captures(name, server, card)
        forced, forced_q = run_fold_forced(name, server, answered, card,
                                           decode=(client, pts))
        paths.update(forced)
        per_q.update(forced_q)
    paths[f"{name} wire"] = run_wire(
        name, client, server, pub, pts, int(rng.integers(0, params.total_n)),
        pack, path, path_not, card)
    return paths, per_q


def check_k9_captures(tag: str, server, card: str) -> None:
    """Every program `server` captured (its stage chain, its served query,
    its batch) records one K9 launch of each mode, or the run fails."""
    recorded = {key: {k: sum(g.launches[k] for g in prog.graphs)
                      for k in ("compose", "convert")}
                for key, prog in server.graphs.programs.items()}
    print(f"{tag} K9 launches recorded per captured program: {recorded} "
          f"[{card}]", flush=True)
    if not recorded or any(n != {"compose": 1, "convert": 1}
                           for n in recorded.values()):
        raise SystemExit(f"{tag}: a captured program does not record one "
                         f"K9 launch of each mode: {recorded}")


def device_busy_us(prof) -> float:
    """The device's busy microseconds in a torch.profiler trace: the union
    of the intervals of its device-side events (kernels, copies, sets).
    Summing the key averages' self device time would count a kernel twice
    where a CPU op launched it: once on the op, once as the kernel."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def served_calls(run) -> tuple[dict, float]:
    """run() once more under torch.profiler after a warm run: its CUDA
    launch calls by name (cudaGraphLaunch, and any *LaunchKernel*) and
    the device's busy time (device_busy_us, 0 where the trace holds
    none)."""
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()
             if "LaunchKernel" in e.key or "GraphLaunch" in e.key}
    return calls, device_busy_us(prof)


def host_s(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def check_graph_serving(tag: str, server, queries: list, check,
                        card: str, batch: bool = True) -> dict:
    """The served path of `server` as CUDA graphs (graphs.py), each check
    failing the run: process_query (the stage chain) and _run_single (the
    served graph) in turn on queries[0] and queries[1], twice, each give
    the query's eager rows bit for bit (no graph writes over the chain's
    stages); the chain's split of MEASURE_RUNS runs is printed beside the
    device time of a traced served query; GRAPH_QUERIES distinct queries
    enqueued back to back through _run_single and fetched at the end each
    pass check(index, rows); a warm served query makes no host sync in its
    enqueue (count_syncs) and, in a torch.profiler trace, one
    cudaGraphLaunch and no kernel launch; with `batch`, a batch of
    GRAPH_QUERIES replayed twice equals its eager run.  Prints the served
    seconds eager and as a graph (host clock until the rows are on the
    host, SERVED_RUNS each in turns), pipelined seconds a query both ways,
    the device's busy share of each (the device time of one traced run,
    device_busy_us, over the least untraced served seconds), and each
    graph's capture seconds and pool bytes.  Returns those numbers."""
    from spiral_tpu_torch.crypto.decode import responses_from_device_rows

    q = queries[0]
    direct = q.packed_b is None

    def same(a, b):
        return same_rows(a, b) if not isinstance(a, list) else all(
            same_rows(x, y) for x, y in zip(a, b))

    def fetch(rows):
        return [x.cpu() for x in rows]

    # the stage chain is not clobbered by the served graph: process_query
    # and _run_single in turn on two queries, each equal to its eager rows
    for x in (q, queries[1], q, queries[1]):
        want = server._response(*fetch(server._run_eager(x)))
        chained, _ = server.process_query(x)
        served = server._response(*server._run_single(x))
        if not (same(chained, want) and same(served, want)):
            raise SystemExit(f"{tag} graph: the stage chain's rows equal "
                             f"the eager rows={same(chained, want)}, the "
                             f"served graph's={same(served, want)}")
    splits = [server.process_query(q)[1] for _ in range(MEASURE_RUNS)]

    eager_s, graph_s = [], []
    for turn in range(SERVED_RUNS):
        runs = [(eager_s, server._run_eager), (graph_s, server._run_single)]
        for times, serve in runs[::1 - 2 * (turn % 2)]:
            times.append(host_s(lambda: fetch(serve(q))))
    fused_s = server.process_query_fused(q)[1]

    def pipelined(serve):
        outs = [serve(x) for x in queries]
        return [fetch(rows) for rows in outs]

    outs = pipelined(server._run_single)
    bad = [i for i, rows in enumerate(outs) if not check(i, rows)]
    if bad:
        raise SystemExit(f"{tag} graph: pipelined queries {bad} did not get "
                         f"their own rows")
    pipe_eager = host_s(lambda: pipelined(server._run_eager)) / len(queries)
    pipe_graph = host_s(lambda: pipelined(server._run_single)) / len(queries)
    syncs = count_syncs(lambda: server._run_single(q))
    calls, kernel_us = served_calls(lambda: fetch(server._run_single(q)))
    eager_calls, kernel_eager_us = served_calls(
        lambda: fetch(server._run_eager(q)))

    def count(c, what):
        return sum(v for k, v in c.items() if what in k)

    # the eager run's kernel launches show that the trace sees launch calls
    if syncs or count(calls, "LaunchKernel") or \
            count(calls, "GraphLaunch") != 1 or \
            not count(eager_calls, "LaunchKernel"):
        raise SystemExit(f"{tag} graph: a warm served query made host syncs "
                         f"{syncs} and launch calls {calls} (eager: "
                         f"{eager_calls})")
    g, e = min(graph_s), min(eager_s)

    def busy(us, s):
        return round(us / (s * 1e6), 3) if us else "not measured"

    stats = server.graphs.stats()
    single = stats[("single", direct, 1)]
    chain = {k[:-3]: [round(getattr(t, k), 1) for t in splits]
             for k in vars(splits[0]) if any(getattr(t, k) for t in splits)}
    totals = [round(t.total_us, 1) for t in splits]
    print(f"{tag} stage chain split (process_query, CUDA events between the "
          f"per-stage graph replays, {MEASURE_RUNS} runs, us): {chain}; "
          f"totals {totals} against {kernel_us:.1f} us of device time in a "
          f"traced served query [{card}]", flush=True)
    out = {"stages_us": chain, "stages_total_us": totals,
           "served_eager_ms": e * 1e3, "served_graph_ms": g * 1e3,
           "served_eager_max_ms": max(eager_s) * 1e3,
           "served_graph_max_ms": max(graph_s) * 1e3,
           "fused_ms": fused_s * 1e3, "pipelined_eager_ms": pipe_eager * 1e3,
           "pipelined_graph_ms": pipe_graph * 1e3,
           "busy_eager": busy(kernel_eager_us, e), "busy_graph":
           busy(kernel_us, g), "device_us_eager": kernel_eager_us,
           "device_us_graph": kernel_us,
           "capture_s": single["capture_s"],
           "pool_bytes": single["pool_bytes"]}
    print(f"{tag} graph: the stage chain's and the served graph's rows, in "
          f"turn, equal the eager rows; "
          f"{len(queries)} pipelined distinct queries each correct; 0 host "
          f"syncs; trace of a served query: {calls} (eager: "
          f"{eager_calls}); served eager "
          f"{e * 1e3:.3f}-{max(eager_s) * 1e3:.3f} ms / graph "
          f"{g * 1e3:.3f}-{max(graph_s) * 1e3:.3f} ms (host clock until the "
          f"rows are on the host, {SERVED_RUNS} each in turns; "
          f"process_query_fused {fused_s * 1e3:.3f} ms), pipelined eager "
          f"{pipe_eager * 1e3:.3f} / graph {pipe_graph * 1e3:.3f} ms a query; "
          f"device busy eager {out['busy_eager']} / graph "
          f"{out['busy_graph']} (device time of a traced run "
          f"{kernel_eager_us:.1f} / {kernel_us:.1f} us); capture {single['capture_s']:.3f} s, pool "
          f"+{single['pool_bytes'] / 2**20:.1f} MiB, warm run "
          f"{single['warm_s']:.3f} s [{card}]", flush=True)
    if batch:
        # the eager batch in process_query_batch's window: its stages, then
        # the rows to the host as Responses
        def eager_batch():
            return responses_from_device_rows(*server._run_batch(queries))

        want_b = eager_batch()
        b_eager, runs = [], []
        for _ in range(2):
            b_eager.append(host_s(eager_batch))
            runs.append(server.process_query_batch(queries))
        if not all(same_rows(a, b) for resps, _ in runs
                   for a, b in zip(resps, want_b)):
            raise SystemExit(f"{tag} graph: a replayed batch differs from "
                             f"its eager run")
        _, kb_eager = served_calls(eager_batch)
        _, kb_graph = served_calls(
            lambda: server.process_query_batch(queries))
        bstats = server.graphs.stats()[("batch", direct, len(queries))]
        b_graph = [s for _, s in runs]
        out.update(batch_eager_ms=min(b_eager) * 1e3,
                   batch_graph_ms=min(b_graph) * 1e3,
                   batch_device_eager_us=kb_eager,
                   batch_device_graph_us=kb_graph,
                   batch_capture_s=bstats["capture_s"],
                   batch_pool_bytes=bstats["pool_bytes"])
        print(f"{tag} graph batch of {len(queries)}: two replays equal the "
              f"eager run; eager {min(b_eager) * 1e3:.3f}-"
              f"{max(b_eager) * 1e3:.3f} ms / graph {min(b_graph) * 1e3:.3f}-"
              f"{max(b_graph) * 1e3:.3f} ms (host clock until the responses "
              f"are on the host, 2 each in turns); device time of a "
              f"traced run {kb_eager:.1f} / {kb_graph:.1f} us; capture "
              f"{bstats['capture_s']:.3f} s, pool "
              f"+{bstats['pool_bytes'] / 2**20:.1f} MiB [{card}]", flush=True)
    stats = server.graphs.stats()
    pool = sum(s["pool_bytes"] for s in stats.values())
    out["pool_total_bytes"] = pool
    out["programs"] = report_captures(tag, server, card)
    print(f"{tag} graph pool: {len(stats)} programs of "
          f"{sum(s['graphs'] for s in stats.values())} graphs, "
          f"{pool / 2**20:.1f} MiB in all [{card}]", flush=True)
    return out


def count_syncs(run) -> list[str]:
    """The host syncs torch reports while run() runs
    (torch.cuda.set_sync_debug_mode("warn")): for each, the line that
    called it and the first line of the warning."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [f"{os.path.relpath(w.filename)}:{w.lineno}: "
                 f"{str(w.message).splitlines()[0]}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def print_syncs(tag: str, syncs: list[str]) -> None:
    counts = collections.Counter(syncs)
    print(f"{tag}: {len(syncs)} host syncs inside the enqueue of one query "
          f"(torch sync debug mode), at {len(counts)} sites: "
          f"{dict(counts)}", flush=True)


def run_wire(name: str, client, server, pub, pts, idx: int, pack: bool,
             path: tuple, path_not: tuple, card: str) -> dict:
    """One query over the wire (serialize.py): query_to_bytes ->
    query_from_bytes -> process_query_fused -> response_to_bytes ->
    response_from_bytes -> decode, against its record and its
    process_query rows; the wire sizes beside the Params' accounting; the
    host syncs inside the fused path's enqueue; the public parameters
    through SPP1 bytes into a second server (equal rows).  At
    CHECKPOINT_PRESET also final_ciphertext (its modulus switch must give
    the rows) and a save_db / load_db round trip of the encoded database
    into a temporary directory.  Returns the fused path's launches,
    counted from 0 before query_to_bytes, which must include every kernel
    of `path` and none of `path_not`."""
    from spiral_tpu_torch import interop, kernels, serialize
    from spiral_tpu_torch.crypto.decode import (modswitch_device,
                                                response_from_device_rows)

    p = server.params
    rows, cols = (p.out_n + 1, p.out_n) if pack else (p.n1, p.n2)
    Server = type(server)
    q = client.query(idx)
    want, tm = server.process_query(q)
    torch.cuda.synchronize()
    kernels.reset_launches()
    qb = serialize.query_to_bytes(q, p)
    resp, seconds = server.process_query_fused(
        serialize.query_from_bytes(qb, p, server.device))
    rb = serialize.response_to_bytes(resp, p)
    back = serialize.response_from_bytes(rb, p, rows, cols)
    launches = dict(kernels.LAUNCHES)
    ok = np.array_equal(client.decode(back), pts[idx].astype(object))
    same = same_rows(back, want)
    print(f"{name} wire query idx={idx}: query {len(qb)} B (Params."
          f"query_size_bytes {p.query_size_bytes()}, client size_bytes "
          f"{q.size_bytes}), response {len(rb)} B (Params."
          f"response_size_bytes {p.response_size_bytes()}); decodes={ok}, "
          f"rows equal process_query's={same}; process_query_fused "
          f"{seconds * 1e3:.3f} ms (host clock until the rows are on the "
          f"host) vs process_query stages {tm.total_us / 1e3:.3f} ms (cuda "
          f"events) stages_us="
          f"{ {k: round(v, 1) for k, v in vars(tm).items()} } launches over "
          f"the wire run (fused: a warm run and a timed one)={launches} "
          f"[{card}]", flush=True)
    if not (ok and same):
        raise SystemExit(f"{name} wire: decodes={ok}, rows equal={same}")
    if not all(launches[k] for k in path) or \
            any(launches[k] for k in path_not):
        raise SystemExit(f"{name} wire: a kernel of the path was never "
                         f"launched, or one of {path_not} was")
    print_syncs(f"{name} process_query_fused",
                count_syncs(lambda: server._run_single(q)))

    pb = serialize.public_params_to_bytes(pub)
    pub2 = serialize.public_params_from_bytes(pb, p, server.device)
    same = same_rows(Server(p, server.db, pub2).process_query(q)[0], want)
    print(f"{name} wire public params: {len(pb)} B (Params."
          f"public_param_size_bytes {p.public_param_size_bytes()}); a "
          f"server on the loaded ones gives equal rows={same}", flush=True)
    if not same:
        raise SystemExit(f"{name} wire: public params changed the rows")
    if name != CHECKPOINT_PRESET:
        return launches

    final = server.final_ciphertext(q)
    same = same_rows(response_from_device_rows(
        *modswitch_device(final, p)), want)
    print(f"{name} final_ciphertext {tuple(final.shape)}: its modulus "
          f"switch equals process_query's rows={same}", flush=True)
    if not same:
        raise SystemExit(f"{name}: final_ciphertext disagrees")
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        need = server.db.data.numel() * 4
        print(f"{name} checkpoint: {free / 2**30:.1f} GiB free in the "
              f"temporary directory, {need / 2**30:.2f} GiB to write",
              flush=True)
        if free < need * 1.05:
            raise SystemExit(f"{name} checkpoint: no room for the database")
        base = os.path.join(tmp, "db")
        t0 = time.perf_counter()
        interop.encoded_db_to_jax_layout(server.db)   # save_db's host copy
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        serialize.save_db(server.db, base)
        t1 = time.perf_counter()
        db2 = serialize.load_db(base, server.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(base + ".npy")
        equal = torch.equal(db2.data, server.db.data)
        same = same_rows(Server(p, db2, pub).process_query(q)[0], want)
        del db2
    print(f"{name} checkpoint: .npy {size} B saved in {t1 - t0:.2f} s (of "
          f"which the copy to the host in the JAX layout alone takes "
          f"{t_host:.2f} s), "
          f"loaded to the card in {t2 - t1:.2f} s; torch.equal to the "
          f"encoded database={equal}, a server on it gives equal rows="
          f"{same}", flush=True)
    if not (equal and same):
        raise SystemExit(f"{name} checkpoint: equal={equal}, rows={same}")
    return launches


def run_factored(seed: int, card: str, name: str = FACTORED_PRESET,
                 factor: int = FACTOR) -> tuple[dict, dict, dict]:
    """Phase 8, oversized items: `factor` sub-databases at `name`, each
    drawn from numpy seed `seed` and encoded into its column block on the
    card one at a time, the host keeping only the queried records; three
    queries (index 0, total_n - 1, a random one) through process_query
    and process_query_fused, every chunk decoded; K2 must launch once per
    run of a query, and K1, K3, K4 and K8a must launch; the encode is
    traced, and must record one spiral.encode span a sub-database and add
    the database's bytes to tracing.COUNTS["encoded_bytes"].  Then K2 at the
    factored shape on the real database and K3's round 1 on the real
    first-dimension output, each held to its plain version and timed.
    Returns ({path: launches}, {path: launches of its last query},
    {kernel: {case: record}})."""
    from spiral_tpu_torch import kernels, tracing
    from spiral_tpu_torch.factored import (FactoredSpiralServer,
                                           decode_factored,
                                           encode_factored_db)
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.pir import SpiralClient
    from spiral_tpu_torch.server import firstdim, fold
    from spiral_tpu_torch.server.db import random_db

    params = preset(name)
    rng = np.random.default_rng(seed)
    idxs = [0, params.total_n - 1, int(rng.integers(0, params.total_n))]
    # the served path's distinct queries: these three and random ones
    gidx = idxs + [int(i) for i in rng.integers(0, params.total_n,
                                                GRAPH_QUERIES - len(idxs))]
    kept = {i: [] for i in gidx}
    draw = [0.0]

    def sub_dbs():
        for _ in range(factor):
            t = time.perf_counter()
            pts = random_db(params, rng)
            draw[0] += time.perf_counter() - t
            for i in kept:
                kept[i].append(pts[i])
            yield pts

    t0 = time.perf_counter()
    encoded = tracing.COUNTS["encoded_bytes"]
    tracing.drain()
    tracing.enable(True)
    try:
        db = encode_factored_db(sub_dbs(), params, "cuda", factor=factor)
        torch.cuda.synchronize()
    finally:
        tracing.enable(False)
    t1 = time.perf_counter()
    spans = [s for s in tracing.drain() if s.name == "spiral.encode"]
    encoded = tracing.COUNTS["encoded_bytes"] - encoded
    client = SpiralClient(params, seed=seed, device="cuda")
    server = FactoredSpiralServer(params, db, client.setup())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    db_bytes = db.data.numel() * 4
    item_bytes = params.total_n * factor * params.n0 * params.n2 * \
        params.poly_len * int(np.log2(params.p_db)) // 8
    print(f"{name} factored x{factor}: {db_bytes / 2**30:.2f} GiB encoded "
          f"on the card ({tuple(db.data.shape)}), {item_bytes} B of items; "
          f"setup: draw {draw[0]:.2f} s, encode {t1 - t0 - draw[0]:.2f} s "
          f"({len(spans)} spiral.encode spans, "
          f"{sum(s.end_ns - s.start_ns for s in spans) / 1e9:.2f} s on the "
          f"host; encoded_bytes {encoded}), client keys+public params and "
          f"server {t2 - t1:.2f} s", flush=True)
    if len(spans) != factor or encoded != db_bytes:
        raise SystemExit(f"{name} factored: {len(spans)} spiral.encode "
                         f"spans for {factor} sub-databases, encoded_bytes "
                         f"{encoded} for {db_bytes} B")

    chain = capture_chain(f"{name} factored", server, client.query(1), card)
    kernels.reset_launches()
    for n, idx in enumerate(idxs):
        q = client.query(idx)
        want = np.stack(kept[idx]).astype(object)
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        resps, tm = server.process_query(q)
        per_query = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        ok = np.array_equal(decode_factored(client, resps), want)
        before = dict(kernels.LAUNCHES)
        fused, seconds = server.process_query_fused(q)
        fused_launches = {k: v - before[k]
                          for k, v in kernels.LAUNCHES.items()}
        fok = np.array_equal(decode_factored(client, fused), want)
        same = all(same_rows(a, b) for a, b in zip(fused, resps))
        stages = {k: round(v, 1) for k, v in vars(tm).items()}
        print(f"{name} factored query idx={idx}: all {factor} chunks "
              f"decode: process_query={ok}, process_query_fused={fok}, "
              f"rows equal={same}; server {tm.total_us / 1e3:.3f} ms (stage "
              f"graphs) stages_us={stages}, fused {seconds * 1e3:.3f} ms "
              f"(host clock until the rows are on the host); first dim "
              f"{db_bytes / tm.first_multiply_us / 1e3:.1f} GB/s of 3,350 "
              f"(incl. the inverse NTT); launches: process_query="
              f"{per_query}, process_query_fused (two runs)="
              f"{fused_launches} [{card}]", flush=True)
        if not (ok and fok and same):
            raise SystemExit(f"{name} factored query {idx}: decodes={ok}, "
                             f"fused decodes={fok}, rows equal={same}")
        # the fused path's two runs, and on its first call the eager run
        # before its tail's capture
        if per_query["firstdim"] != 1 or \
                fused_launches["firstdim"] != 2 + (n == 0):
            raise SystemExit(f"{name} factored: K2 launched "
                             f"{per_query['firstdim']} times in a query, "
                             f"{fused_launches['firstdim']} in the fused "
                             f"path's")
    launches = dict(kernels.LAUNCHES)
    print(f"{name} factored launches over the path: {launches}", flush=True)
    if not all(launches[k] for k in SPIRAL_PATH):
        raise SystemExit(f"{name} factored: a kernel of the path was never "
                         f"launched")
    tail = server.graphs.stats()[("tail", False, 1)]
    print(f"{name} factored served tail graph: capture "
          f"{tail['capture_s']:.3f} s, pool +{tail['pool_bytes'] / 2**20:.1f} "
          f"MiB, warm run {tail['warm_s']:.3f} s [{card}]", flush=True)
    GRAPHS[f"{name} factored"] = check_graph_serving(
        f"{name} factored x{factor}", server,
        [client.query(i) for i in gidx], lambda i, rows: np.array_equal(
            decode_factored(client, server._response(*rows)),
            np.stack(kept[gidx[i]]).astype(object)), card, batch=False)
    GRAPHS[f"{name} factored"].update(
        tail_capture_s=tail["capture_s"], tail_pool_bytes=tail["pool_bytes"],
        **chain)
    print_syncs(f"{name} factored process_query_fused",
                count_syncs(lambda: server._run_single(q)))

    # the kernels at the factored shapes, on the real database
    p = params
    first_b, gsw_b = server.query_scalars_batch([q])
    C_reg = server.compose(first_b[0])
    q_pos, q_neg = server.convert(gsw_b[0])
    qk = firstdim.reorient_query(C_reg)
    K, m = db.data.shape[2:]
    checks = {"firstdim": {}, "fold": {}}
    checks["firstdim"][f"firstdim_factored_x{factor}"] = check_case(
        f"firstdim_factored_x{factor}", "firstdim",
        lambda: firstdim.multiply_query_by_db(db.data, qk),
        lambda: firstdim.multiply_plain(db.data, qk), 5, [db.data, qk], 0,
        K2_MACS_PER_PRODUCT * 2 * p.poly_len * K * m * p.n1)
    cts = server.first_dim(C_reg)
    qn, qp = q_neg[0].contiguous(), q_pos[0].contiguous()
    m_out = cts.shape[0] // 2
    checks["fold"][f"fold_factored_x{factor}_round1"] = check_case(
        f"fold_factored_x{factor}_round1", "fold",
        lambda: fold.fold_round(cts, qn, qp, p.t_gsw),
        lambda: fold.fold_round_plain(cts, qn, qp, p.t_gsw), 5,
        [cts, qn, qp], fold_products(m_out, p.n1, p.n2, p.t_gsw,
                                     p.poly_len))
    return ({f"{name} factored": launches},
            {f"{name} factored": per_query}, checks)


def run_implicit(name: str, seed: int, card: str) -> tuple[dict, dict]:
    """The implicit huge-database mode at a full-size preset: a random slab
    of at most 2 GiB streamed num_chunks times, one query, served twice
    (equal rows), then a batch of BATCH queries that holds it; the batch's
    rows for that query must equal the single run's; then that query with
    the fold forced to one engine (run_fold_forced).  Returns ({path:
    launches}, {path: launches of its last query})."""
    from spiral_tpu_torch import kernels
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.pir import SpiralClient, SpiralServer
    from spiral_tpu_torch.server.db import random_implicit_db

    params = preset(name)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    db = random_implicit_db(params, rng, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    client = SpiralClient(params, seed=seed, device="cuda")
    pub = client.setup()
    server = SpiralServer(params, db, pub)
    torch.cuda.synchronize()
    slab_bytes = db.slab.numel() * 4
    streamed = db.num_chunks * slab_bytes
    db_bytes = params.total_n * params.n0 * params.n2 * params.poly_len * \
        int(np.log2(params.p_db)) // 8
    print(f"{name} implicit setup: slab {slab_bytes / 2**30:.2f} GiB "
          f"({db.slab_per} of {params.num_per} rows, {db.num_chunks} "
          f"chunks) in {t1 - t0:.2f} s, client keys+public params "
          f"{time.perf_counter() - t1:.2f} s", flush=True)

    bidx = [int(i) for i in rng.integers(0, params.total_n, BATCH - 2)]
    bidx = bidx[:1] + [0, params.total_n - 1] + bidx[1:]
    qs = [client.query(i) for i in bidx]
    chain = capture_chain(f"{name} implicit", server, client.query(1), card)
    torch.cuda.synchronize()
    kernels.reset_launches()
    resp, tm = server.process_query(qs[0])
    single = dict(kernels.LAUNCHES)
    stages = {k: round(v, 1) for k, v in vars(tm).items()}
    print(f"{name} implicit query idx={bidx[0]}: server "
          f"{tm.total_us / 1e3:.3f} ms (stage graphs) "
          f"{db_bytes / tm.total_us:.1f} MB/s stages_us={stages} "
          f"launches={single} [{card}]", flush=True)
    if not all(single[k] for k in IMPLICIT_PATH):
        raise SystemExit(f"{name} implicit: a kernel of the path was never "
                         f"launched")
    # the same query again: the server made the fold's K8b storage (G, 2.2
    # GB in round 1) when it was built, so the first query must not pay
    # for it: the two fold stages should agree
    again, tm = server.process_query(qs[0])
    stages = {k: round(v, 1) for k, v in vars(tm).items()}
    print(f"{name} implicit query idx={bidx[0]} again: rows equal the first "
          f"run's={same_rows(again, resp)} server {tm.total_us / 1e3:.3f} ms "
          f"(stage graphs) {db_bytes / tm.total_us:.1f} MB/s "
          f"stages_us={stages} [{card}]", flush=True)
    if not same_rows(again, resp):
        raise SystemExit(f"{name} implicit: a second run of the query gave "
                         f"other rows")
    kernels.reset_launches()
    resps, seconds = server.process_query_batch(qs)
    batch = dict(kernels.LAUNCHES)
    report_batch(f"{name} implicit batch", server, len(qs), seconds,
                 db_bytes, batch, SPIRAL_BATCH_PATH, card)
    for tag, t in (("query", tm), ("batch", server.last_timings)):
        print(f"{name} implicit {tag}: first-dim stage streams "
              f"{streamed / 2**30:.1f} GiB ({db.num_chunks} x "
              f"{slab_bytes / 2**30:.2f} GiB slab) in "
              f"{t.first_multiply_us / 1e3:.3f} ms (incl. inverse NTT): "
              f"{streamed / t.first_multiply_us / 1e6:.3f} TB/s of 3.35",
              flush=True)
    if not same_rows(resps[0], resp):
        raise SystemExit(f"{name} implicit: the batch's rows for idx "
                         f"{bidx[0]} differ from its single run's")
    print(f"{name} implicit: the batch's rows for idx={bidx[0]} equal the "
          f"single run's", flush=True)
    # the slab is random: each query's served rows must equal its eager rows
    eager = [[x.cpu() for x in server._run_eager(q)] for q in qs]
    GRAPHS[f"{name} implicit"] = check_graph_serving(
        f"{name} implicit", server, qs, lambda i, rows: all(
            torch.equal(a, b) for a, b in zip(rows, eager[i])), card)
    GRAPHS[f"{name} implicit"].update(chain)
    forced, forced_q = run_fold_forced(f"{name} implicit", server,
                                       [(bidx[0], qs[0], resp)], card)
    return ({f"{name} implicit": single, f"{name} implicit batch": batch,
             **forced}, {f"{name} implicit": single, **forced_q})


def served_split(server, query, runs: int) -> list[list[float]]:
    """[the served graph's stage sum (last_timings, its own events), its
    replay timed by two CUDA events around graph.replay()] in us, for
    `runs` replays of the served graph of a packed `query`; fails unless
    each sum is within SERVED_SUM_TOLERANCE of its replay."""
    server._run_single(query)
    (graph,) = server.graphs.programs[("single", False, 1)].graphs
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.graph.replay()
        end.record()
        end.synchronize()
        out.append([server.last_timings.total_us,
                    start.elapsed_time(end) * 1e3])
    print(f"served graph: stage sum (its own events) | replay (two events "
          f"around it), us: "
          f"{'; '.join(f'{a:.1f} | {b:.1f}' for a, b in out)}", flush=True)
    if any(abs(a - b) > SERVED_SUM_TOLERANCE * b for a, b in out):
        raise SystemExit(f"the served graph's stage sums {out} lie outside "
                         f"{SERVED_SUM_TOLERANCE:.0%} of its replays")
    return out


def run_stage_split(seed: int, card: str, name: str = MEASURE_PRESET
                    ) -> None:
    """Phase 9's stage split at `name`: profiling.device_stage_times (the
    served graph of one query replayed back to back, its stages read from
    the events it records; it raises if the replayed rows differ from the
    eager rows) beside the stage chain's split of process_query (CUDA
    events between its per-stage graph replays) in MEASURE_RUNS runs on
    an idle card and MEASURE_RUNS runs each behind a served query (the
    card busy when the chain starts, as back-to-back replays keep it),
    the served graph's stage sum (last_timings) against its replay timed
    by two events around it (served_split), and process_query_fused's
    seconds; then a torch.profiler trace of MEASURE_RUNS served queries,
    whose kernel time over their host seconds is the device's busy share.
    The chain's rows must equal _run_eager's, the response after
    profiling the one before, the served stage sum fused_total_us to
    within STAGE_SUM_TOLERANCE and each replay's time to within
    SERVED_SUM_TOLERANCE, and each stage's median over the chain's runs
    behind a served query the served graph's stage to within
    max(CHAIN_TOLERANCE, CHAIN_TOLERANCE_US)."""
    from spiral_tpu_torch import profiling
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.pir import SpiralClient, SpiralServer
    from spiral_tpu_torch.server.db import encode_db, random_db

    params = preset(name)
    rng = np.random.default_rng(seed)
    pts = random_db(params, rng)
    client = SpiralClient(params, seed=seed, device="cuda")
    server = SpiralServer(params, encode_db(pts, params, "cuda"),
                          client.setup())
    del pts
    idx = int(rng.integers(0, params.total_n))
    q = client.query(idx)
    capture_chain(name, server, q, card)
    before, _ = server.process_query(q)
    eager = server._response(*server._run_eager(q))
    if not same_rows(before, eager):
        raise SystemExit(f"{name}: the stage chain's rows differ from the "
                         f"eager rows")
    server.process_query_fused(q)
    single = server.graphs.stats()[("single", False, 1)]
    print(f"{name} served graph captured after the stage chain: capture "
          f"{single['capture_s']:.3f} s, pool "
          f"+{single['pool_bytes'] / 2**20:.1f} MiB, warm run "
          f"{single['warm_s']:.3f} s [{card}]", flush=True)
    graph = profiling.device_stage_times(server, q)
    served = served_split(server, q, MEASURE_RUNS)
    after, _ = server.process_query(q)
    idle = [server.process_query(q)[1] for _ in range(MEASURE_RUNS)]
    # each behind a served query, enqueued with no sync: the card is busy
    # when the chain starts, as in device_stage_times' back-to-back replays
    events = []
    for _ in range(MEASURE_RUNS):
        server._run_single(q)
        events.append(server.process_query(q)[1])
    fused = min(server.process_query_fused(q)[1]
                for _ in range(MEASURE_RUNS))
    same = same_rows(before, after)
    print(f"{name} stage split idx={idx}: the graph-replayed rows equal the "
          f"eager rows (device_stage_times checks them; the stage chain's "
          f"too); the response after profiling equals the one before={same} "
          f"[{card}]", flush=True)
    if not same:
        raise SystemExit(f"{name}: profiling changed the response")
    print(f"{name} stage split, us: stage, the served graph's events "
          f"(iters 8, best of 3), process_query's stage chain (CUDA events "
          f"between per-stage graph replays; {MEASURE_RUNS} runs each "
          f"behind a served query), chain median - served, the chain on an "
          f"idle card ({MEASURE_RUNS} runs) [{card}]", flush=True)
    off = []
    split = {}
    for stage in profiling.STAGES:
        g = graph[f"{stage}_us"]
        runs = [getattr(t, f"{stage}_us") for t in events]
        cold = [getattr(t, f"{stage}_us") for t in idle]
        med = float(np.median(runs))
        split[stage] = {"served": g, "chain": runs, "chain_idle": cold}
        print(f"  {stage}: {g} | {', '.join(f'{e:.1f}' for e in runs)} | "
              f"{med - g:+.1f} | {', '.join(f'{e:.1f}' for e in cold)}",
              flush=True)
        if abs(med - g) > max(CHAIN_TOLERANCE * g, CHAIN_TOLERANCE_US):
            off.append(stage)
    stage_sum = sum(graph[f"{s}_us"] for s in profiling.STAGES)
    total = graph["fused_total_us"]
    totals = [t.total_us for t in events]
    GRAPHS[f"{name} stage split"] = {
        **split, "total": {"served": total, "chain": totals,
                           "chain_idle": [t.total_us for t in idle]},
        "served_sum_vs_replay": served}
    print(f"  total: stage sum {stage_sum}, fused_total_us {total} | "
          f"{', '.join(f'{e:.1f}' for e in totals)} | "
          f"{float(np.median(totals)) - total:+.1f} | "
          f"{', '.join(f'{t.total_us:.1f}' for t in idle)}; "
          f"process_query_fused "
          f"{fused * 1e3:.3f} ms (host clock until the rows are on the host, "
          f"least of {MEASURE_RUNS})", flush=True)
    if abs(stage_sum - total) > max(3, STAGE_SUM_TOLERANCE * total):
        raise SystemExit(f"{name}: the stage sum {stage_sum} us is not "
                         f"fused_total_us {total}")
    if off:
        raise SystemExit(f"{name}: the stage chain's {off} lie outside "
                         f"max({CHAIN_TOLERANCE:.0%}, {CHAIN_TOLERANCE_US} "
                         f"us) of the served graph's stages")
    # the device's busy share of the served path from a profiler trace:
    # device time (torch.profiler, CUPTI: device_busy_us) over the host
    # seconds of MEASURE_RUNS traced served queries, each fetched to the
    # host (the trace's own host overhead is in those seconds)
    [x.cpu() for x in server._run_single(q)]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(MEASURE_RUNS):
            [x.cpu() for x in server._run_single(q)]
        wall = (time.perf_counter() - t0) / MEASURE_RUNS
    kernel = device_busy_us(prof) / MEASURE_RUNS
    busy = (f"busy {kernel / (wall * 1e6):.3f}, idle "
            f"{1 - kernel / (wall * 1e6):.3f}" if kernel else
            "not measured (the trace holds no device time)")
    print(f"  profiler trace of {MEASURE_RUNS} served queries: device time "
          f"{kernel:.1f} us a query (served graph {total}) in "
          f"{wall * 1e6:.1f} us of host time: device {busy} [{card}]",
          flush=True)


def run_measure(seed: int, card: str) -> dict:
    """Phase 9, the measurement layer: the stage split (run_stage_split),
    then the port's bench, harness ubench and harness packingcomp in this
    process, each printing its JSON line (MEASURE_RUNS_ARGV), its
    launches counted from 0 and required for every kernel of its path.
    A wrong decode, a failed capture or a kernel of a path never launched
    fails the run.  Returns {path: launches}."""
    from spiral_tpu_torch import bench, harness, kernels

    run_stage_split(seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    paths = {}
    with tempfile.TemporaryDirectory() as results:
        for tag, module, argv, path in MEASURE_RUNS_ARGV:
            main = {"bench": bench.main, "harness": harness.main}[module]
            if module == "harness":
                argv = argv + ["--results-dir", results]
            t0 = time.perf_counter()
            kernels.reset_launches()
            rc = main(argv)
            launches = dict(kernels.LAUNCHES)
            print(f"measure {tag}: rc {rc}, {time.perf_counter() - t0:.2f} "
                  f"s, launches {launches} [{card}]", flush=True)
            if rc != 0:
                raise SystemExit(f"measure {tag}: exit code {rc}")
            if not all(launches[k] for k in path):
                raise SystemExit(f"measure {tag}: a kernel of {path} was "
                                 f"never launched")
            paths[f"measure {tag}"] = launches
            gc.collect()
            torch.cuda.empty_cache()
    return paths


def run_main(tag: str, main, argv: list, card: str,
             path: tuple = ()) -> tuple[str, dict]:
    """One CLI's main(argv) in this process, its launches counted from 0:
    -> (the last line it printed, the launches).  A nonzero exit code, or
    a kernel of `path` never launched, fails the run."""
    from spiral_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    launches = dict(kernels.LAUNCHES)
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"paramgen {tag}: rc {rc}, {time.perf_counter() - t0:.2f} s, "
          f"launches {launches} [{card}]\n  {line}", flush=True)
    if rc != 0:
        raise SystemExit(f"paramgen {tag}: exit code {rc}")
    if not all(launches[k] for k in path):
        raise SystemExit(f"paramgen {tag}: a kernel of {path} was never "
                         f"launched")
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches


def run_paramgen(card: str) -> dict:
    """Phase 10, parameter selection: select_params' runs on the card
    (PARAMGEN_RUNS, each decoded), the dry-run selection, build_lut at
    LUT_PRESET into a temporary file and the selection figures.  Returns
    {path: launches} of the runs that serve queries."""
    from spiral_tpu_torch import harness, select_params
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.paramgen import build_lut, search

    paths = {}
    for tag, argv, path in PARAMGEN_RUNS:
        line, launches = run_main(tag, select_params.main, argv, card, path)
        out = json.loads(line)
        if out["is_corr"] is not True:
            raise SystemExit(f"paramgen {tag}: wrong decode")
        paths[f"paramgen {tag}"] = launches
    run_main("select_params " + " ".join(PARAMGEN_DRY), select_params.main,
             PARAMGEN_DRY, card)
    sel = search.select_params(int(PARAMGEN_DRY[0]), int(PARAMGEN_DRY[1]))
    print(f"  selected {build_lut.lut_key(sel.params)} q' "
          f"{sel.params.q_prime_bits} x {sel.factor}: cost {sel.cost} s, "
          f"measured {sel.measured} (H100 LUT, {build_lut.KERNEL_VERSION})",
          flush=True)
    committed = build_lut.DEFAULT_LUT.read_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "lut.json")
        _, launches = run_main(
            f"build_lut {LUT_PRESET}", build_lut.main,
            ["--presets", LUT_PRESET, "--out", out, "--trials", "2"], card,
            SPIRAL_PATH)
        paths[f"paramgen build_lut {LUT_PRESET}"] = launches
        with open(out) as f:
            entry = json.load(f)[build_lut.lut_key(preset(LUT_PRESET))]
        shown = {k: v for k, v in entry.items() if k != "params"}
        print(f"  entry: {json.dumps(shown)}", flush=True)
        if not (entry["is_corr"] is True and entry["card"] == card and
                entry["kernel_version"] == build_lut.KERNEL_VERSION):
            raise SystemExit(f"build_lut {LUT_PRESET}: entry {entry}")
        for figure in PARAMGEN_FIGURES:
            run_main(f"harness {figure}", harness.main,
                     [figure, "--results-dir", tmp], card)
    if build_lut.DEFAULT_LUT.read_bytes() != committed:
        raise SystemExit("phase 10 changed the committed H100 LUT")
    return paths


def count_launches(tag: str, run, path: tuple, card: str):
    """run() with the launches counted from 0 -> (its result, the
    launches); fails if a kernel of `path` was never launched."""
    from spiral_tpu_torch import kernels
    kernels.reset_launches()
    out = run()
    launches = dict(kernels.LAUNCHES)
    print(f"{tag} launches: {launches} [{card}]", flush=True)
    if not all(launches[k] for k in path):
        raise SystemExit(f"{tag}: a kernel of {path} was never launched")
    return out, launches


def uncounted(run):
    """run(), its launches taken out of the counts again: a timing's
    repeats are not the path's launches."""
    from spiral_tpu_torch import kernels
    before = dict(kernels.LAUNCHES)
    out = run()
    kernels.LAUNCHES.update(before)
    return out


def mesh_graph_rows(tag: str, server, ref, queries: list, card: str
                    ) -> dict:
    """A mesh server's served graph (its all-gather captured) gives the
    unsharded server's served graph's rows for each query, and its
    programs hold the served, chain and batch graphs of the paths driven
    so far (serving "cuda_graph").  Returns its stage chain's stats
    (chain_stats)."""
    same = all(all(torch.equal(a, b) for a, b in zip(
        server._run_single(q), ref._run_single(q))) for q in queries)
    print(f"{tag}: the served graph's rows equal the unsharded server's "
          f"served graph's={same} for {len(queries)} queries; serving "
          f"{server.serving}; programs {list(server.graphs.programs)} "
          f"[{card}]", flush=True)
    if not same or server.serving != "cuda_graph":
        raise SystemExit(f"{tag}: graph rows equal={same}, serving "
                         f"{server.serving}")
    return chain_stats(tag, server, False, card)


def dist_spiral(seed: int, card: str, mesh) -> dict:
    """Phase 11 at DIST_PRESET: the sharded server (mesh of 1) against the
    unsharded one, queries, batch, ingest, the contraction split and the
    one-rank-at-a-time worlds (DIST_WORLDS, and a batch at
    DIST_BATCH_WORLD), each rank a server on shard.RankOf.  Returns {path:
    launches}."""
    from spiral_tpu_torch.crypto.decode import (modswitch_device,
                                                response_from_device_rows,
                                                responses_from_device_rows)
    from spiral_tpu_torch import graphs
    from spiral_tpu_torch.dist import multihost, shard
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.pir import SpiralClient, SpiralServer
    from spiral_tpu_torch.server.db import encode_db, random_db
    from spiral_tpu_torch.server.firstdim import (multiply_query_by_db,
                                                  reorient_query)

    name, params = DIST_PRESET, preset(DIST_PRESET)
    rng = np.random.default_rng(seed)
    pts = random_db(params, rng)
    db = encode_db(pts, params, torch.device("cuda"))
    client = SpiralClient(params, seed=seed, device="cuda")
    pub = client.setup()
    ref = SpiralServer(params, db, pub)
    server = SpiralServer(params, db, pub, mesh=mesh)
    idxs = [0, params.total_n - 1, int(rng.integers(0, params.total_n))]
    qs = [client.query(i) for i in idxs]
    torch.cuda.synchronize()
    paths = {}

    def serve_all():
        return [server.process_query(q) for q in qs]

    sharded, paths[f"{name} sharded"] = count_launches(
        f"{name} sharded, {len(qs)} queries", serve_all, SPIRAL_PATH, card)
    answers = []
    for idx, q, (resp, tm) in zip(idxs, qs, sharded):
        want, tm_ref = ref.process_query(q)
        ok = np.array_equal(client.decode(resp), pts[idx].astype(object))
        same = same_rows(resp, want)
        # served times in turns: unsharded, sharded, sharded, unsharded
        served = [srv.process_query_fused(q)[1] for srv in
                  (ref, server, server, ref)]
        print(f"{name} sharded (mesh of 1) query idx={idx}: correct={ok} "
              f"rows equal the unsharded server's={same}; process_query "
              f"{tm.total_us / 1e3:.3f} ms (stage graphs; first dim + fold "
              f"{tm.first_multiply_us / 1e3:.3f}, folding_us "
              f"{tm.folding_us}) against unsharded {tm_ref.total_us / 1e3:.3f}"
              f" ms (first dim {tm_ref.first_multiply_us / 1e3:.3f} + fold "
              f"{tm_ref.folding_us / 1e3:.3f}); process_query_fused unsharded"
              f" {served[0] * 1e3:.3f}, {served[3] * 1e3:.3f} ms, sharded "
              f"{served[1] * 1e3:.3f}, {served[2] * 1e3:.3f} ms (host clock) "
              f"[{card}]", flush=True)
        if not (ok and same and tm.folding_us == 0):
            raise SystemExit(f"{name} sharded query {idx}: decodes={ok}, "
                             f"rows equal={same}, folding_us {tm.folding_us}")
        answers.append(want)

    bidx = idxs + [int(i) for i in rng.integers(0, params.total_n,
                                                BATCH - len(idxs))]
    bqs = [client.query(i) for i in bidx]
    torch.cuda.synchronize()
    (resps, seconds), paths[f"{name} sharded batch"] = count_launches(
        f"{name} sharded batch", lambda: server.process_query_batch(bqs),
        SPIRAL_BATCH_PATH, card)
    want_b, seconds_ref = ref.process_query_batch(bqs)
    same = all(same_rows(a, b) for a, b in zip(resps, want_b))
    print(f"{name} sharded batch of {len(bqs)}: rows equal the unsharded "
          f"batch's={same}; {seconds * 1e3:.3f} ms against unsharded "
          f"{seconds_ref * 1e3:.3f} ms (host clock, until the rows are on "
          f"the host) [{card}]", flush=True)
    if not same:
        raise SystemExit(f"{name} sharded batch: rows differ")
    GRAPHS[f"{name} sharded"] = check_graph_serving(
        f"{name} sharded (mesh of 1)", server, bqs, lambda i, rows:
        np.array_equal(client.decode(server._response(*rows)),
                       pts[bidx[i]].astype(object)), card)
    GRAPHS[f"{name} sharded"].update(mesh_graph_rows(
        f"{name} sharded", server, ref, bqs[:len(qs)], card))

    def ingest():
        t0 = time.perf_counter()
        srv = multihost.ingest_and_serve(lambda rec: pts[rec], params, pub,
                                         device="cuda")
        torch.cuda.synchronize()
        print(f"{name} ingest_and_serve: encode_db_local and the server in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        return [srv.process_query(q)[0] for q in qs]

    got, paths[f"{name} ingest_and_serve"] = count_launches(
        f"{name} ingest_and_serve", ingest, SPIRAL_PATH, card)
    same = all(same_rows(a, b) for a, b in zip(got, answers))
    print(f"{name} ingest_and_serve: the {len(qs)} queries' rows equal the "
          f"unsharded server's={same} [{card}]", flush=True)
    if not same:
        raise SystemExit(f"{name} ingest_and_serve: rows differ")
    gc.collect()
    torch.cuda.empty_cache()

    first_b, gsw_b = ref.query_scalars_batch([qs[0]])
    C_reg = ref.compose(first_b[0])
    q_pos, q_neg = ref.convert(gsw_b[0])
    want = ref.fold(ref.first_dim(C_reg), q_pos, q_neg)
    step = shard.sharded_firstdim_and_fold(params, mesh)
    got, paths[f"{name} contraction split"] = count_launches(
        f"{name} sharded_firstdim_and_fold", lambda: step(
            shard.shard_db(db.data, mesh), reorient_query(C_reg), q_pos,
            q_neg), DIST_FOLD_PATH, card)
    same = torch.equal(got, want)
    print(f"{name} sharded_firstdim_and_fold: equals the unsharded fold "
          f"output={same}", flush=True)
    if not same:
        raise SystemExit(f"{name} sharded_firstdim_and_fold differs")
    # psum_mod inside a capture: the contraction step as one CUDA graph
    # (its communicator exists: the step above made it)
    args = (shard.shard_db(db.data, mesh), reorient_query(C_reg), q_pos,
            q_neg)
    (graph,), (out,) = graphs.capture(
        lambda mark: (step(*args),), 1, lambda _: "the contraction step",
        torch.device("cuda"))
    uncounted(graph.replay)
    same = torch.equal(out, want)
    print(f"{name} sharded_firstdim_and_fold as a CUDA graph (psum_mod's "
          f"all-reduce captured): equals the unsharded fold output={same}; "
          f"capture {graph.capture_s:.3f} s [{card}]", flush=True)
    if not same:
        raise SystemExit(f"{name} sharded_firstdim_and_fold's graph differs")
    del graph, out, args

    qk = reorient_query(C_reg)
    n1, d = params.n1, params.poly_len
    for world in DIST_WORLDS:
        rows_local = params.num_per // world

        def ranks():
            """Each rank's program on the server code that serves at
            `world`: its block's K2 (timed), first dim and local rounds;
            the survivors stacked in rank order, then the tail."""
            survivors = []
            for rank in range(world):
                srv = SpiralServer(params, db, pub,
                                   mesh=shard.RankOf(world, rank))
                block = srv.db.data
                ms, how = uncounted(lambda: cuda_ms(
                    lambda: multiply_query_by_db(block, qk), 5))
                m_loc = block.shape[-1]
                nbytes = (block.numel() + qk.numel() + 2 * d * n1 * m_loc) * 4
                mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = K2_MACS_PER_PRODUCT * 2 * d * block.shape[2] * \
                    m_loc * n1 / INT8_MACS_PER_S * 1e3
                bound = max(mem_ms, ops_ms)
                print(f"{name} world {world} rank {rank}: K2 over its "
                      f"{block.numel() * 4 / 2**30:.3f} GiB block "
                      f"({rows_local} rows) {ms:.4f} ms ({how}) bound "
                      f"{bound:.4f} ms ({'bytes' if mem_ms >= ops_ms else 'operations'}"
                      f": {nbytes} B at 3.35 TB/s; {bound / ms:.1%} of it) "
                      f"[{card}]", flush=True)
                first_b, gsw_b = srv.query_scalars_batch([qs[0]])
                q_pos, q_neg = srv.convert(gsw_b[0])
                cts = srv.first_dim(srv.compose(first_b[0]))
                survivors.append(shard.fold_local(cts, q_pos, q_neg, params,
                                                  srv._fold_g))
                del srv, block, cts
            final = shard.fold_tail(torch.cat(survivors), q_pos, q_neg,
                                    params)
            return response_from_device_rows(*modswitch_device(final,
                                                               params))

        resp, paths[f"{name} world {world} one rank at a time"] = \
            count_launches(f"{name} world {world} one rank at a time", ranks,
                           SPIRAL_PATH, card)
        same = same_rows(resp, answers[0])
        print(f"{name} world {world}, {world} ranks one at a time: rows "
              f"equal the unsharded server's={same}", flush=True)
        if not same:
            raise SystemExit(f"{name} world {world}: rows differ")
        gc.collect()
        torch.cuda.empty_cache()

    world = DIST_BATCH_WORLD

    def batch_ranks():
        survivors = []
        for rank in range(world):
            srv = SpiralServer(params, db, pub, mesh=shard.RankOf(world, rank))
            first_b, gsw_b = srv.query_scalars_batch(bqs)
            q_pos_b, q_neg_b = srv.convert(gsw_b)
            cts_b = srv.first_dim_batch(srv.compose(first_b))
            survivors.append(shard.fold_local_batch(cts_b, q_pos_b, q_neg_b,
                                                    params))
            del srv, cts_b
        finals = shard.fold_tail_batch(torch.cat(survivors, 1), q_pos_b,
                                       q_neg_b, params)
        return responses_from_device_rows(*modswitch_device(finals, params))

    got, paths[f"{name} batch world {world} one rank at a time"] = \
        count_launches(f"{name} batch of {len(bqs)}, world {world} one rank "
                       f"at a time", batch_ranks, SPIRAL_BATCH_PATH, card)
    same = all(same_rows(a, b) for a, b in zip(got, want_b))
    print(f"{name} batch of {len(bqs)}, world {world}, {world} ranks one at "
          f"a time (K5 local rounds and tail): rows equal the unsharded "
          f"batch's={same}", flush=True)
    if not same:
        raise SystemExit(f"{name} batch world {world}: rows differ")
    return paths


def dist_pack_implicit(seed: int, card: str, mesh) -> dict:
    """Phase 11: a sharded PackServer at DIST_PACK_PRESET and a sharded
    implicit query at DIST_IMPLICIT_PRESET (a mesh of 1, then
    DIST_BATCH_WORLD ranks one at a time, each on shard.RankOf), each
    against the unsharded server on the same database.  Returns {path:
    launches}."""
    from spiral_tpu_torch import pack as pk
    from spiral_tpu_torch.crypto.decode import (modswitch_device,
                                                response_from_device_rows)
    from spiral_tpu_torch.dist import shard
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.pir import SpiralClient, SpiralServer
    from spiral_tpu_torch.server.db import random_implicit_db

    paths = {}
    name, params = DIST_PACK_PRESET, preset(DIST_PACK_PRESET)
    rng = np.random.default_rng(seed)
    pts = pk.random_pack_db(params, rng)
    db = pk.encode_pack_db(pts, params, torch.device("cuda"))
    client = pk.PackClient(params, seed=seed, device="cuda")
    pub = client.setup()
    gidx = [int(i) for i in rng.integers(0, params.total_n, GRAPH_QUERIES)]
    idx = gidx[0]
    q = client.query(idx)
    torch.cuda.synchronize()
    server = pk.PackServer(params, db, pub, mesh=mesh)
    (resp, tm), paths[f"{name} sharded"] = count_launches(
        f"{name} sharded", lambda: server.process_query(q), PACK_PATH, card)
    ref = pk.PackServer(params, db, pub)
    want, tm_ref = ref.process_query(q)
    ok = np.array_equal(client.decode(resp), pts[idx].astype(object))
    same = same_rows(resp, want)
    print(f"{name} sharded (mesh of 1) query idx={idx}: correct={ok} rows "
          f"equal the unsharded server's={same}; {tm.total_us / 1e3:.3f} ms "
          f"against {tm_ref.total_us / 1e3:.3f} ms (stage graphs) [{card}]",
          flush=True)
    if not (ok and same):
        raise SystemExit(f"{name} sharded: decodes={ok}, rows equal={same}")
    gqs = [q] + [client.query(i) for i in gidx[1:]]
    GRAPHS[f"{name} sharded"] = check_graph_serving(
        f"{name} sharded (mesh of 1)", server, gqs, lambda i, rows:
        np.array_equal(client.decode(server._response(*rows)),
                       pts[gidx[i]].astype(object)), card)
    GRAPHS[f"{name} sharded"].update(mesh_graph_rows(
        f"{name} sharded", server, ref, gqs[:2], card))
    del db, resp, want, server, ref
    gc.collect()
    torch.cuda.empty_cache()

    name, params = DIST_IMPLICIT_PRESET, preset(DIST_IMPLICIT_PRESET)
    idb = random_implicit_db(params, rng, device="cuda")
    client = SpiralClient(params, seed=seed, device="cuda")
    pub = client.setup()
    qs = [client.query(int(i))
          for i in rng.integers(0, params.total_n, GRAPH_QUERIES)]
    q = qs[0]
    torch.cuda.synchronize()
    server = SpiralServer(params, idb, pub, mesh=mesh)
    (resp, tm), paths[f"{name} implicit sharded"] = count_launches(
        f"{name} implicit sharded", lambda: server.process_query(q),
        IMPLICIT_PATH, card)
    ref = SpiralServer(params, idb, pub)
    want, tm_ref = ref.process_query(q)
    same = same_rows(resp, want)
    print(f"{name} implicit sharded (mesh of 1, {idb.num_chunks} chunks): "
          f"rows equal the unsharded server's={same}; "
          f"{tm.total_us / 1e3:.3f} ms against {tm_ref.total_us / 1e3:.3f} "
          f"ms (stage graphs) [{card}]", flush=True)
    if not same:
        raise SystemExit(f"{name} implicit sharded: rows differ")
    # the slab is random: each query's served rows must equal its eager
    # rows; a sharded batch over an implicit slab raises, so no batch
    eager = [[x.cpu() for x in server._run_eager(x)] for x in qs]
    GRAPHS[f"{name} implicit sharded"] = check_graph_serving(
        f"{name} implicit sharded (mesh of 1)", server, qs, lambda i, rows:
        all(torch.equal(a, b) for a, b in zip(rows, eager[i])), card,
        batch=False)
    GRAPHS[f"{name} implicit sharded"].update(mesh_graph_rows(
        f"{name} implicit sharded", server, ref, qs[:2], card))
    del server, ref
    gc.collect()
    torch.cuda.empty_cache()

    world = DIST_BATCH_WORLD

    def ranks():
        """Each rank streams its num_chunks / world chunks of the slab,
        its query rolled by its first chunk, then its local rounds."""
        survivors = []
        for rank in range(world):
            srv = SpiralServer(params, idb, pub, mesh=shard.RankOf(world, rank))
            first_b, gsw_b = srv.query_scalars_batch([q])
            q_pos, q_neg = srv.convert(gsw_b[0])
            cts = srv.first_dim(srv.compose(first_b[0]))
            survivors.append(shard.fold_local(cts, q_pos, q_neg, params,
                                              srv._fold_g))
            del srv, cts
        final = shard.fold_tail(torch.cat(survivors), q_pos, q_neg, params)
        return response_from_device_rows(*modswitch_device(final, params))

    # a rank's local rounds still reach K8b's sizes (512 cts out and up)
    resp, paths[f"{name} implicit world {world} one rank at a time"] = \
        count_launches(f"{name} implicit world {world} one rank at a time",
                       ranks, IMPLICIT_PATH, card)
    same = same_rows(resp, want)
    print(f"{name} implicit, world {world}, {world} ranks one at a time "
          f"({idb.num_chunks // world} chunks each): rows equal the "
          f"unsharded server's={same}", flush=True)
    if not same:
        raise SystemExit(f"{name} implicit world {world}: rows differ")
    return paths


def run_dist(seed: int, card: str) -> dict:
    """Phase 11, scale-out: a real NCCL world of one rank in this process
    (a failed init or collective raises), the sharded servers against the
    unsharded ones (dist_spiral, dist_pack_implicit), graft_entry's step
    and dryrun_multichip(1), and harness dist --devices 1.  Returns {path:
    launches}."""
    import torch.distributed as dist
    from spiral_tpu_torch import graft_entry, harness
    from spiral_tpu_torch.dist import multihost, shard

    multihost.initialize(f"localhost:{multihost.free_port()}", 1, 0,
                         device="cuda")
    try:
        print(f"dist: a world of {dist.get_world_size()}, backend "
              f"{dist.get_backend()}", flush=True)
        mesh = shard.make_db_mesh(1, "cuda")
        paths = dist_spiral(seed, card, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(dist_pack_implicit(seed, card, mesh))
        gc.collect()
        torch.cuda.empty_cache()

        def graft():
            fn, args = graft_entry.entry("cuda")
            out = fn(*args)
            graft_entry.dryrun_pipeline(1, "cuda")
            return out

        # dryrun_multichip(1): its pipeline counted, its kernel check not
        out, paths["graft_entry"] = count_launches(
            "graft_entry entry() and dryrun_pipeline(1)", graft,
            SPIRAL_PATH, card)
        uncounted(lambda: graft_entry.check_kernels(
            graft_entry.dryrun_params(1)))
        print(f"graft_entry: entry() step {tuple(out.shape)}, "
              f"dryrun_multichip(1) decoded and its kernels (K3, K4, K8a, "
              f"K1) equal their plain versions", flush=True)
        with tempfile.TemporaryDirectory() as results:
            rc, paths["harness dist"] = count_launches(
                "harness dist --devices 1", lambda: harness.main(
                    ["dist", "--devices", "1", "--results-dir", results]),
                SPIRAL_PATH, card)
            rows = json.loads(open(os.path.join(
                results, "dist_results.json")).read())
        print(f"harness dist --devices 1: rc {rc}, rows {rows}", flush=True)
        if rc != 0 or len(rows) != 1 or not rows[0]["correct"]:
            raise SystemExit(f"harness dist: rc {rc}, rows {rows}")
    finally:
        gc.collect()     # graphs holding a collective go before the group
        dist.destroy_process_group()
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3d and print its JSON (no end "
                         "to end run, no ok line): kernel times to compare "
                         "two trees on one card")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spiral_tpu_torch import kernels

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)

    def phase(label, t0):
        print(f"phase {label}: {time.perf_counter() - t0:.2f} s wall",
              flush=True)
        return time.perf_counter()

    t0 = time.perf_counter()
    kernels.lib(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, "
          f"{len(kernels.SOURCES)} sources in parallel and the link: "
          f"{kernels.build_seconds:.2f} s)", flush=True)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    t0 = phase("2 build", t0)

    checks = check_kernels(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    fold_rounds = compare_fold_rounds(torch.Generator(
        device="cuda").manual_seed(args.seed))
    probe = library_probe()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = phase("3 kernel checks", t0)
    k4_launches = time_expand_launches(torch.Generator(
        device="cuda").manual_seed(args.seed))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = phase("3b K4 per launch", t0)
    k1_k8a = time_ntt_auto_launches(torch.Generator(
        device="cuda").manual_seed(args.seed))
    torch.cuda.empty_cache()
    t0 = phase("3c K1 and K8a per launch", t0)
    for kernel, recs in check_selected(torch.Generator(
            device="cuda").manual_seed(args.seed)).items():
        checks[kernel].update(recs)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = phase("3d the selected 30 KB parameters", t0)
    if args.kernels_only:
        print(json.dumps({"checks": checks, "fold_rounds": fold_rounds,
                          "expand_launches": k4_launches,
                          "ntt_auto_launches": k1_k8a}))
        print(card)
        return 0
    paths, per_query = {}, {}
    for phase_label, name, pack, path, batch_path in (
            ("4 spiral", "spiral_20_256", False, SPIRAL_PATH,
             SPIRAL_BATCH_PATH),
            ("5 pack", "spiralpack_20_256", True, PACK_PATH,
             PACK_BATCH_PATH)):
        check_tiny("tiny_pack" if pack else "tiny", args.seed, pack=pack)
        p, q = run_path(name, args.seed, card, pack, path, batch_path)
        paths.update(p)
        per_query.update(q)
        gc.collect()
        torch.cuda.empty_cache()      # the database is freed here
        t0 = phase(phase_label, t0)
    p, q = run_implicit("spiral_24_256", args.seed, card)
    paths.update(p)
    per_query.update(q)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = phase("6 implicit", t0)
    check_tiny("tiny_stream", args.seed, pack=False)
    check_tiny("tiny_subround", args.seed, pack=False, must=SUBROUND_PATH)
    check_tiny("tiny_stream_pack", args.seed, pack=True)
    for name, pack, path, batch_path, path_not in (
            ("spiralstream_20_256", False, STREAM_PATH, STREAM_BATCH_PATH,
             STREAM_NOT),
            ("spiralstreampack_20_256", True, STREAM_PACK_PATH,
             STREAM_PACK_BATCH_PATH, ())):
        p, q = run_path(name, args.seed, card, pack, path, batch_path,
                        path_not)
        paths.update(p)
        per_query.update(q)
        gc.collect()
        torch.cuda.empty_cache()      # the database is freed here
    t0 = phase("7 stream", t0)
    p, q, c = run_factored(args.seed, card)
    paths.update(p)
    per_query.update(q)
    for kernel, recs in c.items():
        checks[kernel].update(recs)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = phase("8 factored", t0)
    print(f"before phase 9: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated on the card", flush=True)
    paths.update(run_measure(args.seed, card))
    t0 = phase("9 measure", t0)
    paths.update(run_paramgen(card))
    t0 = phase("10 paramgen", t0)
    paths.update(run_dist(args.seed, card))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = phase("11 dist", t0)

    out = []
    for kernel, (src, repl) in KERNEL_META.items():
        recs = checks[kernel]
        main_case = next(iter(recs.values()))
        by_path = {k: v[kernel] for k, v in paths.items()}
        out.append({
            "name": kernel, "route": "cuda", "source": src, "replaces": repl,
            # the launches of the driven runs, each counted from 0;
            # launches_by_path and launches_per_query split it
            "launches": sum(by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "launches_by_path": by_path,
            "launches_per_query": {k: v[kernel]
                                   for k, v in per_query.items()},
            "cases": recs})
        if kernel in KERNEL_NOTES:
            out[-1]["note"] = KERNEL_NOTES[kernel]
    next(r for r in out if r["name"] == "expand")["per_launch"] = k4_launches
    for r in out:
        if r["name"] in k1_k8a:
            r["per_launch"] = k1_k8a[r["name"]]
    fc = next(r for r in out if r["name"] == "fold_contract")
    fc["library_probe"] = probe      # why library_ms is null
    fc["fold_rounds_k3_vs_k8b"] = fold_rounds
    print(f"graphs {json.dumps(GRAPHS)}", flush=True)
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
