"""Serving through CUDA graphs: the counterpart of the JAX package's
compiled programs, one jitted program per query form and batch size
(spiral_tpu/pir.py:353-425 ``full_packed`` / ``full_direct`` and their
batch forms, pack.py:501-625, factored.py:82-85) and one per stage for
``process_query`` (pir.py:344-351 ``_stage_*``, pack.py:467-473).

A server owns one GraphRunner.  ``run(key, body, sources, stages)``
answers one call of the program `key` names (the path, the query form,
the batch size), as jax.jit compiles once per shape:

- On first use of `key` it allocates the static input tensors and copies
  the call's inputs into them, runs the path once eagerly (on a side
  stream on the card, so that the device constants the pipeline builds
  lazily, the kernel library's first build and a process group's first
  collective, which makes its communicator, land outside the graphs'
  pool) and, on a CUDA device, captures ``body`` in the server's one
  memory pool: as one CUDA graph, or for a stage chain (``chain=True``)
  as one graph per stage, each cut where the body marks the end of a
  stage.  A stage's inputs are then the earlier stages' outputs where
  their capture left them, with no copy between stages.
- Every call copies its inputs into the static tensors on the current
  stream (so after the previous replay), replays the graphs in order and
  returns clones of the static outputs made on the same stream: a later
  call's inputs never reach an earlier call's replay, and its outputs
  never alias an earlier call's.

Each program keeps its stage names (``stages``), and its stages are timed
by a StageClock (its ``clock``, read lazily; the runner remembers the key
it replayed last, ``last``).  A path captured as one graph records its
clock into the graph: the body's stage marks, and one mark before its
first stage, are timing events captured as event-record nodes, which
every replay records again.  A chain's clock marks CUDA events between
its stages' replays.

A chain is replayed whole, from its first stage, in every call, and no
other graph replays between its stages: the pool is shared, so another
graph's replay may write over the addresses of a stage's outputs that a
later stage reads (the clone at the end guards the last stage's).

A body takes only its static tensors and a stage mark: nothing of a query
reaches the graph but through them.  A capture that fails raises, naming
the server, the path and the stage it was in; nothing falls back to
eager serving.  Captures run in the thread-local error mode, so that
another thread's event queries (a process group's watchdog) cannot break
them.

On a CPU server (the caller's choice, as the tests make it) nothing is
captured, so no warm run is made: the runner runs ``body`` eagerly on the
staged inputs each call, its stages marked on the host clock, writes its
results into the static outputs (the first run's results become them) and
clones them the same way.

Kernel launches (kernels.LAUNCHES): a capture launches nothing, so the
counts its kernel wrappers add while it records are taken back out, and
each replay, which launches every recorded kernel once, adds them again.
Each capture counts in tracing.COUNTS["captures"]; a program's first call
is traced as the span "capture" (warm run and capture), its staging as
"stage" and each replay as "replay" (tracing.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from . import kernels, tracing


def no_mark() -> None:
    """The stage mark of an unmarked run."""


class StageClock:
    """Stage marks, one made with the clock: timing CUDA events on a CUDA
    device, else the host clock.  With ``external`` the events are made
    while a CUDA graph captures, as event-record nodes of the graph: each
    replay records them again, and the intervals read the last replay."""

    def __init__(self, device: torch.device, external: bool = False):
        self.cuda = device.type == "cuda"
        self.external = external
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True, external=self.external)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter_ns())

    def intervals_us(self) -> list[float]:
        """Microseconds between consecutive marks (on the card after a
        sync on the last)."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) * 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e-3 for a, b in zip(self.marks, self.marks[1:])]


@dataclasses.dataclass
class Staged:
    """One static input: its shape and the tensors that fill it, one after
    another along its rows (dim 0 of a view of it shaped as the parts' row
    shape), e.g. each query's b rows in a batch."""
    shape: tuple
    parts: list

    @classmethod
    def whole(cls, t: torch.Tensor) -> "Staged":
        return cls(tuple(t.shape), [t])

    def empty(self, device) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.parts[0].dtype,
                           device=device)

    def copy_into(self, static: torch.Tensor) -> None:
        """Copy the parts into `static` on the current stream, with no host
        sync (CUDA stages a pageable host part before it returns)."""
        rows = static.view((-1,) + tuple(self.parts[0].shape[1:]))
        i = 0
        for t in self.parts:
            rows[i:i + t.shape[0]].copy_(t, non_blocking=True)
            i += t.shape[0]
        if i != rows.shape[0]:
            raise ValueError(f"{i} staged rows for a static input of "
                             f"{rows.shape[0]}")


def static_inputs(sources: list[Staged], device) -> list[torch.Tensor]:
    """Tensors for `sources`, allocated and filled."""
    statics = [s.empty(device) for s in sources]
    for s, t in zip(sources, statics):
        s.copy_into(t)
    return statics


def warm_up(run: Callable[[], object], device: torch.device):
    """run() once eagerly -> its result: on a CUDA device on a side stream,
    ordered after the current stream's work and before its later work, as
    torch.cuda.graphs documents for the run before a capture."""
    if device.type != "cuda":
        return run()
    side = torch.cuda.Stream(device)
    current = torch.cuda.current_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = run()
    current.wait_stream(side)
    return out


class Graph:
    """One CUDA graph, capturing from when it is made until end():
    ``launches`` (the kernel launches one replay makes), ``capture_s``
    (host seconds of the capture), ``pool_bytes`` (memory_reserved added by
    the capture, the graph's share of its pool) and, for a path captured
    whole, ``clock`` (its stage events; None for a chain's stage)."""

    def __init__(self, device: torch.device, pool=None):
        self.device = device
        self.clock: StageClock | None = None
        self.graph = torch.cuda.CUDAGraph()
        self._launches = dict(kernels.LAUNCHES)
        self._reserved = torch.cuda.memory_reserved(device)
        self._t0 = time.perf_counter()
        self.capturing = True
        self.graph.capture_begin(pool=pool,
                                 capture_error_mode="thread_local")

    def end(self) -> None:
        """End the capture (a failed capture raises here too)."""
        self.capturing = False
        try:
            self.graph.capture_end()
        finally:
            before = self._launches
            self.launches = {k: v - before[k]
                             for k, v in kernels.LAUNCHES.items()}
            kernels.LAUNCHES.update(before)
        self.capture_s = time.perf_counter() - self._t0
        self.pool_bytes = (torch.cuda.memory_reserved(self.device) -
                           self._reserved)

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n


def capture(run: Callable[[Callable[[], None]], tuple], stages: int,
            what: Callable[[int], str], device: torch.device, pool=None,
            chain: bool = False) -> tuple[list[Graph], tuple]:
    """run(mark), after the caller's warm run, captured on a side stream:
    as one graph whose clock records an event before run and at each mark,
    or with `chain` as `stages` graphs, each ending where run calls mark
    (stage i's graph at its i-th call; run enqueues nothing after its
    last).  -> (the graphs, the tensors run returned: each replay rewrites
    them).  A failed capture raises RuntimeError naming what(the number of
    stages run marked before it failed)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    graphs, marked = [], []

    def mark():
        if chain:
            graphs[-1].end()
            if len(marked) + 1 < stages:
                graphs.append(Graph(device, pool))
        else:
            graphs[0].clock.mark()
        marked.append(1)

    with torch.cuda.stream(torch.cuda.Stream(device)):
        graphs.append(Graph(device, pool))
        try:
            if not chain:
                graphs[0].clock = StageClock(device, external=True)
            out = tuple(run(mark))
            if not chain:
                graphs[-1].end()
            elif len(marked) != stages:
                raise RuntimeError(f"{len(marked)} stage marks for "
                                   f"{stages} stages")
        except RuntimeError as e:
            if graphs[-1].capturing:
                try:
                    graphs[-1].end()
                except RuntimeError:
                    pass
            raise RuntimeError(f"CUDA graph capture of {what(len(marked))} "
                               f"failed: {e}") from e
    return graphs, out


class _Program:
    """A path's static inputs and stage names and, on the card, its graphs
    (one, or one per stage of a chain); its static outputs; the StageClock
    of its last run."""

    def __init__(self, inputs: list[torch.Tensor], stages: tuple):
        self.inputs, self.stages = inputs, stages
        self.graphs: list[Graph] = []
        self.chain = False
        self.outputs: tuple | None = None
        self.clock: StageClock | None = None
        self.warm_s: float | None = None      # the card's warm run


class GraphRunner:
    """One server's programs, keyed by (path, direct form, batch size), and
    the one memory pool their graphs share (torch.cuda.graph_pool_handle):
    graphs replay one at a time on one stream, so a graph may reuse what
    another's capture freed.  ``release()`` frees them; so does freeing
    the server."""

    def __init__(self, device: torch.device, owner: str):
        self.device, self.owner = device, owner
        self.programs: dict[tuple, _Program] = {}
        self.pool = None
        self.last: tuple | None = None     # the key replayed last

    def prepare(self, key: tuple, body: Callable, sources: list[Staged],
                stages: tuple, chain: bool = False):
        """Make `key`'s program unless it exists: its static inputs from
        `sources`, its stage names `stages` and, on the card, one warm run
        of the body and the capture of body(*inputs, mark), which calls
        mark after each stage: one graph, or with `chain` one graph per
        stage.  A failed capture names the stage it was in."""
        if key in self.programs:
            return
        prog = _Program(static_inputs(sources, self.device), stages)
        if self.device.type != "cuda":
            self.programs[key] = prog
            return
        with tracing.span("capture"):
            t0 = time.perf_counter()
            warm_up(lambda: body(*prog.inputs, no_mark), self.device)
            warm_s = time.perf_counter() - t0

            def what(i: int) -> str:
                return (f"{self.owner} path {key} in stage "
                        f"{stages[min(i, len(stages) - 1)]}")

            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            prog.graphs, prog.outputs = capture(
                lambda mark: body(*prog.inputs, mark), len(stages), what,
                self.device, self.pool, chain)
        tracing.COUNTS["captures"] += 1
        prog.chain = chain
        prog.clock = prog.graphs[0].clock
        prog.warm_s = warm_s
        self.programs[key] = prog

    def stage(self, key: tuple, sources: list[Staged]) -> None:
        """Copy `sources` into `key`'s static inputs."""
        for s, t in zip(sources, self.programs[key].inputs):
            s.copy_into(t)

    def replay(self, key: tuple, body: Callable) -> tuple:
        """Run `key`'s program on its staged inputs: replay its graph (its
        clock's events record again) or its chain's graphs with a new
        clock marked after each (on the CPU: run body, the host clock
        marked after each stage, and write the static outputs), and return
        clones of the static outputs."""
        prog = self.programs[key]
        with tracing.span("replay"):
            if prog.graphs and not prog.chain:
                prog.graphs[0].replay()
            else:
                prog.clock = StageClock(self.device)
                for graph in prog.graphs:
                    graph.replay()
                    prog.clock.mark()
            if not prog.graphs:
                outs = tuple(body(*prog.inputs, prog.clock.mark))
                if prog.outputs is None:
                    prog.outputs = outs
                else:
                    for o, r in zip(prog.outputs, outs):
                        o.copy_(r)
            self.last = key
            return tuple(x.clone() for x in prog.outputs)

    def run(self, key: tuple, body: Callable, sources: list[Staged],
            stages: tuple, chain: bool = False) -> tuple:
        """Serve one call of `key`: prepare on first use and stage
        `sources` (span "stage"), then replay -> clones of the static
        outputs."""
        with tracing.span("stage"):
            self.prepare(key, body, sources, stages, chain=chain)
            self.stage(key, sources)
        return self.replay(key, body)

    def stats(self) -> dict:
        """{key: {"warm_s", "capture_s", "pool_bytes", "graphs"}} of the
        programs made, a chain's capture seconds and pool bytes summed over
        its stages (None on the CPU, with 0 graphs)."""
        return {k: {"warm_s": p.warm_s,
                    "capture_s": sum(g.capture_s for g in p.graphs)
                    if p.graphs else None,
                    "pool_bytes": sum(g.pool_bytes for g in p.graphs)
                    if p.graphs else None,
                    "graphs": len(p.graphs)}
                for k, p in self.programs.items()}

    def release(self) -> None:
        """Free every graph, its static tensors and (once nothing else
        holds it) the pool."""
        self.programs.clear()
        self.pool = None
        self.last = None
