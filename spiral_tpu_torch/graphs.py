"""Serving through CUDA graphs: the counterpart of the JAX package's one
jitted program per query form and batch size (spiral_tpu/pir.py:353-425
``full_packed`` / ``full_direct`` and their batch forms, pack.py:501-625,
factored.py:82-85).

A server owns one GraphRunner.  ``run(key, body, sources, stages)``
answers one call of the path `key` names (the path, the query form, the
batch size), as jax.jit compiles once per shape:

- On first use of `key` it allocates the static input tensors and copies
  the call's inputs into them, runs the path once eagerly (on a side
  stream on the card, so that the device constants the pipeline builds
  lazily, and the kernel library's first build, land outside the graph's
  pool) and, on a CUDA device, captures ``body`` as a CUDA graph in the
  server's one memory pool.
- Every call copies its inputs into the static tensors on the current
  stream (so after the previous replay), replays the graph, and returns
  clones of the graph's static outputs made on the same stream: a later
  call's inputs never reach an earlier call's replay, and its outputs
  never alias an earlier call's.

A body takes only its static tensors and a stage mark: nothing of a query
reaches the graph but through them.  A capture that fails raises, naming
the path and the stage it was in; nothing falls back to eager serving.

On a CPU server (the caller's choice, as the tests make it) nothing is
captured, so no warm run is made: the runner runs ``body`` eagerly on the
staged inputs each call, with the caller's stage mark, writes its results
into the static outputs (the first run's results become them) and clones
them the same way.

Kernel launches (kernels.LAUNCHES): a capture launches nothing, so the
counts its kernel wrappers add while it records are taken back out, and
each replay, which launches every recorded kernel once, adds them again.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from . import kernels


def no_mark() -> None:
    """The stage mark of an unmarked run."""


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
    """run() captured as a CUDA graph, after one eager warm run (warm_up;
    `warm` in place of run where given): ``outputs`` (the tensors run()
    returned in the capture, written by each replay), ``launches`` (the
    kernel launches one replay makes), ``capture_s`` (host seconds of the
    capture) and ``pool_bytes`` (memory_reserved added by the capture, the
    graph's share of its pool).  A failed capture raises RuntimeError
    naming what(), called when it fails."""

    def __init__(self, run: Callable[[], tuple], what: Callable[[], str],
                 device: torch.device, pool=None, warm=None):
        warm_up(warm or run, device)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = dict(kernels.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = tuple(run())
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of {what()} failed: "
                               f"{e}") from e
        finally:
            self.launches = {k: v - before[k]
                             for k, v in kernels.LAUNCHES.items()}
            kernels.LAUNCHES.update(before)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n


class _Program:
    """A path's static inputs and, on the card, its graph; its static
    outputs."""

    def __init__(self, inputs: list[torch.Tensor]):
        self.inputs = inputs
        self.graph: Graph | None = None
        self.outputs: tuple | None = None
        self.warm_out = None    # what the warm run returned
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

    def prepare(self, key: tuple, body: Callable, sources: list[Staged],
                stages: tuple, warm: Callable | None = None):
        """Make `key`'s program unless it exists: its static inputs from
        `sources` and, on the card, one warm run (`warm`(*inputs) where
        given, its result kept as the program's ``warm_out``, else the
        body) and the capture of body(*inputs, mark), whose marks after
        each of `stages` name the stage a failed capture was in."""
        if key in self.programs:
            return
        prog = _Program(static_inputs(sources, self.device))
        if self.device.type != "cuda":
            self.programs[key] = prog
            return
        t0 = time.perf_counter()

        def warm_run():
            if warm is None:
                body(*prog.inputs, no_mark)
            else:
                prog.warm_out = warm(*prog.inputs)

        marked = []

        def what() -> str:
            stage = stages[min(len(marked), len(stages) - 1)]
            return f"{self.owner} path {key} in stage {stage}"

        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        prog.graph = Graph(lambda: body(*prog.inputs,
                                        lambda: marked.append(1)),
                           what, self.device, self.pool, warm_run)
        prog.outputs = prog.graph.outputs
        prog.warm_s = time.perf_counter() - t0 - prog.graph.capture_s
        self.programs[key] = prog

    def run(self, key: tuple, body: Callable, sources: list[Staged],
            stages: tuple, mark: Callable[[], None] = no_mark) -> tuple:
        """Serve one call of `key` (prepare on first use): stage `sources`
        into the static inputs, replay the graph (on the CPU: run body,
        `mark` called after each stage, and write the static outputs), and
        return clones of the static outputs."""
        self.prepare(key, body, sources, stages)
        prog = self.programs[key]
        for s, t in zip(sources, prog.inputs):
            s.copy_into(t)
        if prog.graph is not None:
            prog.graph.replay()
        elif prog.outputs is None:
            prog.outputs = tuple(body(*prog.inputs, mark))
        else:
            for o, r in zip(prog.outputs, body(*prog.inputs, mark)):
                o.copy_(r)
        return tuple(x.clone() for x in prog.outputs)

    def stats(self) -> dict:
        """{key: {"warm_s", "capture_s", "pool_bytes"}} of the programs
        made (None on the CPU)."""
        return {k: {"warm_s": p.warm_s,
                    "capture_s": p.graph and p.graph.capture_s,
                    "pool_bytes": p.graph and p.graph.pool_bytes}
                for k, p in self.programs.items()}

    def release(self) -> None:
        """Free every graph, its static tensors and (once nothing else
        holds it) the pool."""
        self.programs.clear()
        self.pool = None
