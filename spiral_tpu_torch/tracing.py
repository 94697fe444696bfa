"""Program tracing of the served path: host spans and counters.

Off by default, switched by ``enable(on)``.  ``span(name)`` marks one
piece of host work where it happens (parse, serve with its stage and
replay, capture, response with its fetch, pack; in set-up, encode: one
encode_db call, so one a sub-database of encode_factored_db).  Off, it
costs one flag check and returns a shared null context.  On, it records
a ``Span`` in memory (name ``spiral.<name>``, start and end on
``time.perf_counter_ns``, the innermost span open when it started as its
parent, a request id) and, while a profiler runs, opens a
``torch.profiler.record_function`` of the same name, so the profiler puts
the span on the card's timeline and clock.  ``drain()`` hands the
recorded spans over once, when the caller asks for them.  Spans are
recorded from one thread, the one that serves.

The spans of one served call share its request id: the program's query
count when the call started (``count_queries``).  A span opened outside a
served call (a query parsed before it, a response packed after it) has
none.

``COUNTS`` is always counted: ``queries`` served (one a query through a
served program, B for a batch), ``captures`` (programs captured as
CUDA graphs, GraphRunner.prepare) and ``encoded_bytes`` (the bytes
encode_db writes to the device: the whole database over a factored
database's sub-databases).  Kernel launches stay in kernels.LAUNCHES.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time

import torch

COUNTS = {"queries": 0, "captures": 0, "encoded_bytes": 0}

_on = False
_spans: list["Span"] = []
_open: list["Span"] = []
_ids = itertools.count()
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: int | None       # the id of the innermost span open at start
    request: int | None      # the served call's id, shared by its spans
    start_ns: int = 0
    end_ns: int = 0


def enable(on: bool = True) -> None:
    """Record spans from now on (on) or stop recording them."""
    global _on
    _on = bool(on)


def count_queries(n: int) -> int:
    """Count n queries served -> the served call's request id (the count
    before them)."""
    first = COUNTS["queries"]
    COUNTS["queries"] += n
    return first


def span(name: str, request: int | None = None):
    """A context around one piece of work: recorded as spiral.<name> while
    tracing is on.  request: the served call's id (default: the enclosing
    span's)."""
    if not _on:
        return _NULL
    return _recorded(name, request)


@contextlib.contextmanager
def _recorded(name: str, request: int | None):
    parent = _open[-1] if _open else None
    if request is None and parent is not None:
        request = parent.request
    s = Span(f"spiral.{name}", next(_ids),
             parent.id if parent is not None else None, request)
    # a record_function costs ~10 us: opened only for a running profiler
    with (torch.profiler.record_function(s.name)
          if torch.autograd._profiler_enabled() else _NULL):
        _open.append(s)
        s.start_ns = time.perf_counter_ns()
        try:
            yield s
        finally:
            s.end_ns = time.perf_counter_ns()
            _open.pop()
            _spans.append(s)


def drain() -> list[Span]:
    """The spans recorded since the last drain, in the order they ended;
    the list is cleared."""
    out = _spans[:]
    _spans.clear()
    return out
