"""The serving core of the port's servers (pir.SpiralServer,
pack.PackServer, factored.FactoredSpiralServer): one base class, Server,
that serves every path through the server's graphs.GraphRunner.

A variant writes its pipeline once, over a leading query axis B, as three
pieces, each calling ``mark`` after each of its stages: ``_front``
(expansion through conversion), ``_middle`` (first dim and fold, here)
and ``_end`` (packing where the variant has it, then the modulus switch;
``_tail`` is the middle and the end).  The modulus switch is the
variant's: pir and pack look up their modswitch_device when it runs.
A batch runs the pieces as they are (``_rows``); one query is the batch
at B = 1, its rows' leading axis dropped by a view (``_single``).  The
fold picks its kernel from B: at B = 1 the variant's one-query fold
(``fold``), else its batch fold (``fold_batch``).

The paths, each a program of graphs.GraphRunner keyed (path, direct form,
B), on a CUDA server CUDA graphs captured on first use (the JAX
package's jitted programs, spiral_tpu/pir.py:344-425), on a CPU server
the same staged runner run eagerly:

- ``_run_single`` (key ("single", form, 1)): one replay of a graph of the
  whole pipeline, the seed's key words and the b rows staged into its
  static inputs, fresh response rows cloned from its outputs;
  ``process_query_fused`` serves a query twice through it and times the
  second run on the host until the response rows are on the host;
- ``process_query`` (("stages", form, 1)): a chain of one graph per
  stage, timed by CUDA events recorded between the replays (the JAX
  server's per-stage jits);
- ``process_query_batch`` (("batch", form, B)): one replay of the graph
  for (form, B); the database streams once per batch.

``last_timings`` reads the stage times of the server's last served call
from its program's StageClock and stage names (``stage_timings``): inside
the graph of a whole path, between the graphs of a chain, on the CPU the
host clock.  ``_run_eager`` and ``_run_batch`` run the same pieces
eagerly: the reference of every served path.  A server's graphs live as
long as it does, or until ``release_graphs()``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from . import tracing
from .crypto.decode import (Response, response_from_device_rows,
                            responses_from_device_rows)
from .crypto.query import Query, seed_words
from .graphs import GraphRunner, Staged, no_mark, static_inputs
from .server.db import EncodedDb, ImplicitDb, ShardedDb


@dataclasses.dataclass
class ServerTimings:
    """Per-stage times in microseconds (names as spiral_tpu.pir)."""
    expansion_us: float = 0.0
    composition_us: float = 0.0
    conversion_us: float = 0.0
    first_multiply_us: float = 0.0
    folding_us: float = 0.0
    packing_us: float = 0.0
    modswitch_us: float = 0.0

    @property
    def db_independent_us(self) -> float:
        return self.expansion_us + self.composition_us + self.conversion_us

    @property
    def db_dependent_us(self) -> float:
        return self.first_multiply_us + self.folding_us + self.packing_us

    @property
    def total_us(self) -> float:
        return sum(dataclasses.astuple(self))


def stage_timings(stages: tuple, intervals: list[float]) -> ServerTimings:
    """A program's stage intervals as ServerTimings: stage `name` in
    ``{name}_us``, and "serve_db" (a sharded server's first dim and fold,
    one stage, as the JAX mesh server reports them) in first_multiply_us
    with folding_us 0.  The fields of stages the program does not run
    stay 0."""
    return ServerTimings(**{
        ("first_multiply" if s == "serve_db" else s) + "_us": t
        for s, t in zip(stages, intervals, strict=True)})


def db_tensor(db: EncodedDb | ImplicitDb | ShardedDb) -> torch.Tensor:
    """The tensor K2 streams: the encoded database, a rank's block of one or
    the implicit slab."""
    return db.slab if isinstance(db, ImplicitDb) else db.data


def query_sources(queries: list[Query]) -> tuple[bool, list[Staged]]:
    """The batch's form (direct or not) and its inputs as a graph stages
    them: the seeds' key words (seed_words, made on the host) and the b
    rows (B, n, 1, 1, 2, d), each query's packed_b, or first_b then
    gsw_b, copied in place.  A batch holds one form: ValueError
    otherwise."""
    if not queries:
        raise ValueError("empty batch")
    forms = {q.packed_b is None for q in queries}
    if len(forms) > 1:
        raise ValueError("a batch mixes packed and direct queries")
    direct = forms.pop()
    words = seed_words([q.seed for q in queries], "cpu")
    parts = [t for q in queries for t in (
        (q.first_b, q.gsw_b) if direct else (q.packed_b,))]
    n = sum(t.shape[0] for t in parts) // len(queries)
    return direct, [Staged.whole(words),
                    Staged((len(queries), n) + tuple(parts[0].shape[1:]),
                           parts)]


def stack_queries(queries: list[Query], device) -> tuple[torch.Tensor,
                                                         torch.Tensor, bool]:
    """The batch's seed words and b rows (B, n, 1, 1, 2, d) in new tensors
    on `device`, and whether they are of the direct form (query_sources;
    n = 1 for the packed form)."""
    direct, sources = query_sources(queries)
    words, bs = static_inputs(sources, device)
    return words, bs, direct


class Server:
    """What every server shares: its GraphRunner, the paths that serve
    through it, the stage times and the pipeline's middle and end.  A
    variant sets ``params``, ``stages`` (its stage names, one a mark of
    the pipeline) and the device through ``__init__``, and defines
    ``_front``, ``first_dim_batch``, ``fold``, ``fold_batch`` and
    ``_end``."""

    _response = staticmethod(response_from_device_rows)

    def __init__(self, device: torch.device, stages: tuple):
        self.device, self.stages = device, stages
        self.graphs = GraphRunner(device, type(self).__name__)

    @property
    def serving(self) -> str:
        """How the server serves: "cuda_graph" (a CUDA server) or "eager"
        (a CPU server)."""
        return "cuda_graph" if self.device.type == "cuda" else "eager"

    def release_graphs(self) -> None:
        """Free the server's CUDA graphs and their pool; the next call of
        each path captures it again."""
        self.graphs.release()

    @property
    def last_timings(self) -> ServerTimings | None:
        """The stage times of the server's last served call (_run_single,
        process_query, process_query_batch, process_query_fused): on the
        card the CUDA events its replay recorded (inside the graph of a
        whole path, between the graphs of a chain), on the CPU the host
        clock of its eager run, named by its program's stages
        (stage_timings).  Read lazily: reading syncs on the events, and
        the value holds until the next served call.  None before the
        first."""
        key = self.graphs.last
        if key is None:
            return None
        prog = self.graphs.programs[key]
        return stage_timings(prog.stages, prog.clock.intervals_us())

    # -- the pipeline over a leading query axis --
    def first_dim(self, x):
        """first_dim_batch of one query's input (no query axis)."""
        return self.first_dim_batch(x[None])[0]

    def _middle(self, x_b, q_pos_b, q_neg_b, mark=no_mark):
        """First dim and fold of a batch, `mark` called after each, or once
        after both where they are one stage ("serve_db", a sharded
        SpiralServer's): the survivors, coefficient domain.  At B = 1 one
        query's fold (fold), else fold_batch."""
        cts_b = self.first_dim_batch(x_b)
        if "serve_db" not in self.stages:
            mark()
        if len(cts_b) == 1:
            finals = self.fold(cts_b[0], q_pos_b[0], q_neg_b[0])[None]
        else:
            finals = self.fold_batch(cts_b, q_pos_b, q_neg_b)
        mark()
        return finals

    def _tail(self, C_reg_b, q_pos_b, q_neg_b, mark=no_mark):
        """The middle and the end of a batch, over what _front gives: its
        rows on the device."""
        return self._end(self._middle(C_reg_b, q_pos_b, q_neg_b, mark), mark)

    def _rows(self, seeds, bs, direct: bool, mark=no_mark):
        """Every stage of a batch (its seeds or seed_words and b rows (B, n,
        1, 1, 2, d)), `mark` called after each: its rows on the device."""
        return self._tail(*self._front(seeds, bs, direct, mark), mark)

    def _single(self, seeds, bs, direct: bool, mark=no_mark):
        """_rows at B = 1, the leading axis dropped by a view: one query's
        rows."""
        return tuple(x[0] for x in self._rows(seeds, bs, direct, mark))

    def _run_eager(self, query: Query, mark=no_mark):
        """Every stage of one query, enqueued eagerly, `mark` called after
        each: the response rows on the device."""
        return self._single(*stack_queries([query], self.device), mark)

    def _run_batch(self, queries: list[Query], mark=no_mark):
        """Every stage of a batch, enqueued eagerly: its rows."""
        return self._rows(*stack_queries(queries, self.device), mark)

    # -- serving through the GraphRunner --
    def _prepare(self, path: str, queries: list[Query], rows=None,
                 stages: tuple | None = None, chain: bool = False):
        """The program of (path, form, B) for `queries`, made on first use
        (GraphRunner.prepare), its body rows(words, bs, direct, mark)
        (default _single) and stages (default the server's).  -> (its
        key, its body over the static inputs, the queries' inputs as
        query_sources gives them)."""
        direct, sources = query_sources(queries)
        key = (path, direct, len(queries))
        rows = rows or self._single

        def body(words, bs, mark):
            return rows(words, bs, direct, mark)

        self.graphs.prepare(key, body, sources, stages or self.stages,
                            chain=chain)
        return key, body, sources

    def _serve(self, path: str, query: Query, chain: bool = False):
        """One query served by the program of `path` (span "serve"): its
        inputs staged (span "stage"), then replayed.  -> fresh response
        rows on the device."""
        with tracing.span("serve", request=tracing.count_queries(1)):
            with tracing.span("stage"):
                key, body, sources = self._prepare(path, [query],
                                                   chain=chain)
                self.graphs.stage(key, sources)
            return self.graphs.replay(key, body)

    def _run_single(self, query: Query):
        """One query served by one replay of the graph of its form (on a
        CPU server the same staged runner, run eagerly): fresh response
        rows on the device."""
        return self._serve("single", query)

    def process_query(self, query: Query):
        """Answer one query of either form: (response, ServerTimings), the
        stages timed one by one by the chain of their graphs.  A direct
        query's reconstruction (and any part's expansion) is timed as its
        expansion_us; the JAX server leaves that field at 0 for direct
        queries, the time falling into its composition."""
        rows = self._serve("stages", query, chain=True)
        return self._response(*rows), self.last_timings

    def process_query_fused(self, query: Query):
        """The serving path: one warm run of _run_single (the first for the
        query's form captures its graph), then a second timed on the host
        clock from the staging of its inputs until the response rows are
        on the host.  -> (response, seconds)."""
        for x in self._run_single(query):
            x.cpu()
        t0 = time.perf_counter()
        rows = [x.cpu() for x in self._run_single(query)]
        seconds = time.perf_counter() - t0
        return self._response(*rows), seconds

    def process_query_batch(self, queries: list[Query]
                            ) -> tuple[list[Response], float]:
        """Answer a batch of queries of one form: (list[Response], seconds),
        the window from the staging's copies until the response rows are
        on the host.  A CUDA server serves it with one replay of the graph
        for (form, B), captured on first use; its stage times are
        ``last_timings``.  A mixed batch raises ValueError."""
        with tracing.span("serve",
                          request=tracing.count_queries(len(queries))):
            with tracing.span("stage"):
                key, body, sources = self._prepare("batch", queries,
                                                   self._rows)
                t0 = time.perf_counter()
                self.graphs.stage(key, sources)
            responses = responses_from_device_rows(
                *self.graphs.replay(key, body))
            return responses, time.perf_counter() - t0
