"""The system under test: the port's server, handed only what a server
gets (the records, through the port's database encoder; the public
parameters as SPP1 bytes; queries as SPQ2 bytes), answering with response
bytes.  The one module of the benchmark that imports the program.

A step serves B queries: each parsed by serialize.query_from_bytes,
answered by the served path (B = 1: pir.serve_single, one CUDA-graph
replay on the card, its rows fetched to the host; B > 1:
process_query_batch, one replay for the batch) and written by
serialize.response_to_bytes.  A factored configuration (factor F > 1)
serves through FactoredSpiralServer, whose answer is F responses.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from spiral_tpu_torch import factored, pir, serialize
from spiral_tpu_torch.params import Params
from spiral_tpu_torch.server.db import encode_db


def program_params(fields: dict) -> Params:
    """The program's Params from a configuration's params object."""
    p = Params(**fields)
    p.validate()
    return p


def _span(name: str, traced: bool):
    return torch.profiler.record_function(name) if traced else \
        contextlib.nullcontext()


class System:
    def __init__(self, fields: dict, records, factor: int, pub_bytes: bytes,
                 device):
        """records: the factor sub-databases (total_n, n0, n2, d) as numpy
        arrays, one at a time (an iterable)."""
        self.params = program_params(fields)
        self.device = torch.device(device)
        pub = serialize.public_params_from_bytes(pub_bytes, self.params,
                                                 self.device)
        if factor == 1:
            (sub,) = list(records)
            db = encode_db(sub, self.params, self.device)
            self.server = pir.SpiralServer(self.params, db, pub)
        else:
            db = factored.encode_factored_db(iter(records), self.params,
                                             self.device, factor=factor)
            self.server = factored.FactoredSpiralServer(self.params, db, pub)
        self.factor = factor

    def _responses(self, resp) -> list[bytes]:
        resps = resp if isinstance(resp, list) else [resp]
        return [serialize.response_to_bytes(r, self.params) for r in resps]

    def step(self, queries: list[bytes], traced: bool = False):
        """Serve one step: -> (one list of response bytes per query, host
        seconds parsing, serving, packing)."""
        t0 = time.perf_counter()
        with _span("pirbench.parse", traced):
            qs = [serialize.query_from_bytes(b, self.params, self.device)
                  for b in queries]
        t1 = time.perf_counter()
        with _span("pirbench.serve", traced):
            if len(qs) == 1:
                rows = [x.cpu() for x in pir.serve_single(self.server, qs[0])]
                resps = [self.server._response(*rows)]
            else:
                resps, _ = self.server.process_query_batch(qs)
        t2 = time.perf_counter()
        with _span("pirbench.pack", traced):
            out = [self._responses(r) for r in resps]
        t3 = time.perf_counter()
        return out, (t1 - t0, t2 - t1, t3 - t2)

    def stage_chain(self, query: bytes):
        """One query through process_query, the chain of per-stage graphs:
        -> (its response bytes, {stage: microseconds})."""
        q = serialize.query_from_bytes(query, self.params, self.device)
        resp, t = self.server.process_query(q)
        return self._responses(resp), {
            "expansion": t.expansion_us, "composition": t.composition_us,
            "conversion": t.conversion_us,
            "first_dim": t.first_multiply_us, "fold": t.folding_us,
            "modswitch": t.modswitch_us}

    def release(self) -> None:
        self.server.release_graphs()
        self.server = None


def record_dtype(p_db: int):
    """The integer type records are handed to the encoder in."""
    return np.int16 if p_db <= (1 << 15) else np.int32
