"""One run of one cell: set-up (records, the client's keys, public
parameters and query pool, the server, the warm-up), the measured window,
in a traced run the profiled window and the stage chain, then the check.

Everything the run makes comes from the seed: the records from a
torch.Generator on the run's device, the client's keys, public parameters
and queries from the plain client's generator on the CPU, the order of
the records asked for from numpy's.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import check, trace
from .reference.client import PlainClient
from .reference.scheme import SchemeParams
from .reference import wire
from .workload import Traffic

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    params: SchemeParams
    factor: int
    batch: int
    setup_s: float             # less the client's seconds
    latencies: list            # seconds, one per query of the window
    window_s: float
    steps: list                # (parse_s, serve_s, pack_s, B) per step
    trace: trace.TraceSummary | None = None
    trace_steps: int = 0
    chain: list = dataclasses.field(default_factory=list)


def load_config(name: str, folder: Path = HERE / "configs") -> dict:
    return json.loads((folder / f"{name}.json").read_text())


def draw_records(p: SchemeParams, factor: int, seed: int, device,
                 dtype) -> list:
    """The factor sub-databases (total_n, n0, n2, d) in [0, p_db), drawn
    on `device` from the seed, as host arrays of `dtype`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (p.total_n, p.n0, p.n2, p.poly_len)
    tdtype = torch.int16 if dtype == np.int16 else torch.int32
    return [torch.randint(0, p.p_db, shape, generator=gen, device=dev,
                          dtype=tdtype).cpu().numpy()
            for _ in range(factor)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(config: dict, traffic: Traffic, seed: int, seconds: float,
             traced: bool, device, t_process: float,
             params_override: dict | None = None) -> dict:
    """-> {"run": Run, "check": {...}, "attempted", "memory_peak_bytes",
    "phases": seconds from the process's start to the end of each phase}.
    t_process: the host clock's reading at the process's start.
    params_override: scheme parameters to change in both the program and
    the client (the control)."""
    from .system import System, record_dtype

    fields = dict(config["params"], **(params_override or {}))
    sp = SchemeParams.from_config(fields)
    factor = int(config.get("factor", 1))
    dev = torch.device(device)
    phases = {"start": time.perf_counter() - t_process}
    records = draw_records(sp, factor, seed, dev, record_dtype(sp.p_db))
    phases["records"] = time.perf_counter() - t_process
    client = PlainClient(sp, seed, device=dev)
    pub_bytes = wire.public_params_to_bytes(client.public_params())
    idxs = traffic.pool_indices(sp.total_n, seed)
    pool = [wire.query_to_bytes(q) for q in client.queries(idxs)]
    phases["client"] = time.perf_counter() - t_process
    if dev.type == "cuda":
        # the peak is the program's: the client's work above is not
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    system = System(fields, records, factor, pub_bytes, dev)
    phases["server"] = time.perf_counter() - t_process
    answers = []

    def serve(k: int, traced_step: bool = False):
        pos = traffic.step(k)
        t0 = time.perf_counter()
        out, spans = system.step([pool[i] for i in pos], traced_step)
        t1 = time.perf_counter()
        answers.extend((int(idxs[i]), r) for i, r in zip(pos, out))
        return t1 - t0, spans

    for k in range(traffic.warm_steps):
        serve(k)
    _sync(dev)

    # the measured window: steps until `seconds` have passed
    latencies, steps = [], []
    k = traffic.warm_steps
    t_start = time.perf_counter()
    phases["warm"] = t_start - t_process
    # set-up is the system's: the benchmark's client making its keys,
    # public parameters and queries is not
    setup_s = t_start - t_process - (phases["client"] - phases["records"])
    t_end = t_start + seconds
    t_last = t_start
    while time.perf_counter() < t_end:
        lat, (parse, srv, pack) = serve(k)
        k += 1
        t_last = time.perf_counter()
        latencies += [lat] * traffic.batch
        steps.append((parse, srv, pack, traffic.batch))
    run = Run(params=sp, factor=factor, batch=traffic.batch,
              setup_s=setup_s, latencies=latencies,
              window_s=t_last - t_start, steps=steps)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    if traced:
        run.trace = _traced_window(serve, k, traffic.trace_steps, dev)
        run.trace_steps = traffic.trace_steps
        k += traffic.trace_steps
        for j in range(traffic.chain_runs):
            i = traffic.step(k + j)[0]
            resps, stages = system.stage_chain(pool[i])
            answers.append((int(idxs[i]), resps))
            if j:           # the first run captures the chain
                run.chain.append(stages)

    system.release()
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    verdict = check.check_answers(client, records, answers, dev)
    phases["check"] = time.perf_counter() - t_process
    return {"run": run, "check": verdict, "attempted": len(answers),
            "memory_peak_bytes": int(peak), "phases": phases}


def _traced_window(serve, k0: int, n: int, dev) -> trace.TraceSummary:
    """n steps served under torch.profiler inside the window span."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for j in range(n):
                serve(k0 + j, traced_step=True)
            _sync(dev)
    return trace.summarize(prof.events(), torch.autograd.DeviceType.CUDA)
