"""Device-true stage times by cumulative prefixes (counterpart of
spiral_tpu/profiling.py).

The JAX function jits the pipeline prefix ending at each stage, runs it
`iters` times inside one program and differences consecutive prefixes,
so that no host time enters.  Its counterpart here is a CUDA graph: the
prefix of SpiralServer._run_single ending at each stage (depth 1..6) is
captured once and replayed `iters` times between two CUDA events, best of
`reps`; consecutive prefixes are differenced, so the stage sum is
fused_total_us but for the rounding.  The capture and the staging of the
query's device inputs (its seed's key words and its b rows, in tensors
made before the capture, so a graph copies nothing from the host) are
the serving path's (graphs.py); replays made here to time a prefix add
nothing to the kernels' launch counts.  A prefix that cannot be captured
raises, naming its stage: nothing falls back to eager timing.

On a CPU server (the caller's choice) the prefixes run eagerly on the
host clock.
"""
from __future__ import annotations

import time

import torch

from . import graphs
from .crypto.decode import modswitch_device
from .pir import SPIRAL_STAGES as STAGES
from .pir import SpiralServer, query_sources


def _prefix(server: SpiralServer, words, bs, depth: int) -> tuple:
    """Stages 1..depth of server._run_single on a packed query's staged
    seed words and b rows (1, 1, 1, 1, 2, d): the last stage's outputs."""
    first_b, gsw_b = server.expand_batch(words, bs)
    if depth == 1:
        return first_b, gsw_b
    C_reg = server.compose(first_b[0])
    if depth == 2:
        return (C_reg,)
    q_pos, q_neg = server.convert(gsw_b[0])
    if depth == 3:
        return q_pos, q_neg
    cts = server.first_dim(C_reg)
    if depth == 4:
        return (cts,)
    final = server.fold(cts, q_pos, q_neg)
    if depth == 5:
        return (final,)
    return modswitch_device(final, server.params)


def _seconds_per_run(run, iters: int, reps: int, cuda: bool) -> float:
    """The best of `reps` timings of `iters` back-to-back runs, per run:
    CUDA events on the card, else the host clock; one warm run first."""
    run()
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                run()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                run()
            seconds = time.perf_counter() - t0
        best = min(best, seconds / iters)
    return best


def prefix_times(server: SpiralServer, query, iters: int = 8,
                 reps: int = 3) -> tuple[list[float], list[torch.Tensor]]:
    """Seconds per run of each cumulative prefix (depth 1..6), and the
    response rows (first, rest) of the full prefix's last run, on the
    host.  On a CUDA server each prefix is one CUDA graph, captured and
    timed, and freed when the next is captured."""
    if not isinstance(server, SpiralServer):
        raise ValueError(f"stage profiling takes a SpiralServer, not a "
                         f"{type(server).__name__}")
    if query.packed_b is None:
        raise ValueError("stage profiling takes a packed query, not the "
                         "direct form")
    cuda = server.device.type == "cuda"
    words, bs = graphs.static_inputs(query_sources([query])[1],
                                     server.device)
    times = []
    for depth, stage in enumerate(STAGES, 1):
        run = lambda d=depth: _prefix(server, words, bs, d)  # noqa: E731
        if cuda:
            # the previous prefix's graph and outputs are freed here
            graph = out = None
            graphs.warm_up(run, server.device)
            (graph,), out = graphs.capture(
                lambda mark, r=run: r(), 1,
                lambda _, s=stage: f"the prefix ending at {s}",
                server.device)
            run = graph.graph.replay
        times.append(_seconds_per_run(run, iters, reps, cuda))
    rows = [x.cpu() for x in (out if cuda else run())]
    return times, rows


def device_stage_times(server: SpiralServer, query, iters: int = 8,
                       reps: int = 3) -> dict:
    """Per-stage device-true times (us) for a SpiralServer and a packed
    query: {"expansion_us", "composition_us", "conversion_us",
    "first_multiply_us", "folding_us", "modswitch_us", "fused_total_us"},
    non-negative ints.  Raises if the full prefix's rows differ from the
    eager stages' (_run_eager): a replay must not change the server's
    state."""
    eager = [x.cpu() for x in server._run_eager(query)]
    times, rows = prefix_times(server, query, iters, reps)
    if not all(torch.equal(a, b) for a, b in zip(rows, eager)):
        raise RuntimeError("the profiled pipeline's response rows differ "
                           "from the eager stages' rows")
    out = {}
    prev = 0.0
    for stage, t in zip(STAGES, times):
        out[f"{stage}_us"] = round(max(0.0, t - prev) * 1e6)
        prev = t
    out["fused_total_us"] = round(times[-1] * 1e6)
    return out
