"""Device-true stage times of the served graph (counterpart of
spiral_tpu/profiling.py).

The JAX function jits the pipeline prefix ending at each stage, runs it
`iters` times inside one program and differences consecutive prefixes,
so that no host time enters.  Here the served program itself is timed:
SpiralServer._run_single's CUDA graph (graphs.py, captured on the
server's first call for the query's form) is replayed `iters` times
between two CUDA events, best of `reps`, and its stages are the
intervals between the timing events the graph records at its stage marks
(graphs.StageClock), read after the best run's last replay.  Their sum is
the graph's time from its first stage to its last, fused_total_us the
replay's time per run.  Replays made here to time the graph add nothing
to the kernels' launch counts.

On a CPU server (the caller's choice) the served runner runs the stages
eagerly on the host clock.
"""
from __future__ import annotations

import time

import torch

from .pir import SPIRAL_STAGES as STAGES
from .pir import SpiralServer
from .serving import stage_timings


def device_stage_times(server: SpiralServer, query, iters: int = 8,
                       reps: int = 3) -> dict:
    """Per-stage device-true times (us) for a SpiralServer and a packed
    query: {"expansion_us", "composition_us", "conversion_us",
    "first_multiply_us", "folding_us", "modswitch_us", "fused_total_us"},
    non-negative ints.  Raises if the profiled replays' rows differ from
    the eager stages' (_run_eager): a replay must not change the server's
    state."""
    if not isinstance(server, SpiralServer):
        raise ValueError(f"stage profiling takes a SpiralServer, not a "
                         f"{type(server).__name__}")
    if query.packed_b is None:
        raise ValueError("stage profiling takes a packed query, not the "
                         "direct form")
    eager = [x.cpu() for x in server._run_eager(query)]
    server._run_single(query)       # captures on first use, stages query
    prog = server.graphs.programs[server.graphs.last]
    cuda = bool(prog.graphs)
    if cuda:
        run = prog.graphs[0].graph.replay
    else:
        def run():
            server._run_single(query)
    best, stages = float("inf"), None
    for _ in range(reps):
        seconds = _seconds_per_run(run, iters, cuda)
        if seconds < best:
            best, stages = seconds, prog.clock.intervals_us()
    rows = [x.cpu() for x in prog.outputs]
    if not all(torch.equal(a, b) for a, b in zip(rows, eager)):
        raise RuntimeError("the profiled graph's response rows differ "
                           "from the eager stages' rows")
    times = stage_timings(prog.stages, stages)
    out = {f"{s}_us": round(max(0.0, getattr(times, f"{s}_us")))
           for s in STAGES}
    out["fused_total_us"] = round(best * 1e6)
    return out


def _seconds_per_run(run, iters: int, cuda: bool) -> float:
    """Seconds per run of `iters` back-to-back runs: CUDA events on the
    card, else the host clock."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) / iters
