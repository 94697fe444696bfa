"""Oversized items (counterpart of spiral_tpu/factored.py): an item of F
records is stored column-wise, chunk f of every item forming sub-database
f, and one query selects index idx in all F sub-databases at once; the F
responses decode to the item's chunks (ref: select_params.py:291-303,
which reruns the whole binary F times).

The F sub-databases sit side by side in the columns of one encoded
database (2, d, K, F*num_per*n2), sub-database f in columns f*num_per*n2
onwards, so the first-dimension multiply is one K2 launch that streams
all of them (the JAX package folds the factor axis into its MXU output
the same way).  Its F*num_per output cts fold as one ct axis, one K3 (or
K8b) launch per round for all sub-databases: a round pairs cts (2o,
2o+1) and num_per is even, so a pair never crosses a sub-database, and
nu_2 rounds leave each sub-database's survivor.  The modulus switch runs
once over the F survivors.  Expansion, composition and conversion are a
SpiralServer's, run once per query; process_query_fused runs them before
its clock starts and times first dim + fold + modswitch, as the JAX
server's does (spiral_tpu/factored.py:82-85, 132-147): on a CUDA server
the query stages (the pipeline's front, serving.py) are a chain of three
CUDA graphs, one per stage, and the tail (its middle and end) one replay
of its CUDA graph, the query stages' outputs staged into
its static inputs (graphs.py's GraphRunner).  _run_single and
process_query (its stage chain) serve the whole query as SpiralServer's
do.
"""
from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from .params import Params
from . import tracing
from .crypto.decode import responses_from_device_rows
from .graphs import Staged
from .pir import SpiralClient, SpiralServer
from .server.db import EncodedDb, encode_db
from .server.fold import fold_rounds


def encode_factored_db(pts: np.ndarray | Iterable[np.ndarray],
                       params: Params, device="cuda",
                       factor: int | None = None) -> EncodedDb:
    """pts (total_n, F, n0, n2, d), as the JAX function takes it, or the F
    sub-databases (total_n, n0, n2, d) one at a time: a sequence, or an
    iterator with `factor` = F.  Each is encoded straight into its column
    block of the (2, d, K, F*num_per*n2) database on `device` (encode_db's
    blocks, a spiral.encode span each while tracing is on), so the host
    holds one sub-database at a time."""
    if isinstance(pts, np.ndarray):
        subs, factor = (pts[:, f] for f in range(pts.shape[1])), pts.shape[1]
    else:
        subs, factor = pts, len(pts) if factor is None else factor
    m = params.num_per * params.n2
    data = torch.empty((2, params.poly_len, params.dim0 * params.n0,
                        factor * m), dtype=torch.int32, device=device)
    n = 0
    for sub in subs:
        if n == factor:
            raise ValueError(f"more than factor = {factor} sub-databases")
        encode_db(sub, params, device, out=data[..., n * m:(n + 1) * m])
        n += 1
    if n != factor:
        raise ValueError(f"{n} sub-databases, factor = {factor}")
    return EncodedDb(data=data, params=params)


QUERY_STAGES = ("expansion", "composition", "conversion")
TAIL_STAGES = ("first_multiply", "folding", "modswitch")


class FactoredSpiralServer(SpiralServer):
    """A SpiralServer over a factored database: process_query gives
    (list of F Responses, ServerTimings), process_query_fused (list of F
    Responses, seconds) and final_ciphertext the F survivors (F, n1, n2,
    2, d).  The stage times are CUDA events, as SpiralServer's, with the
    fold as folding_us and the modulus switch as modswitch_us (the JAX
    server reports the two together as folding_us).  The fold's K8b
    storage is the one a single database's server makes: a round whose G
    is larger (F times, in round 1) allocates its own."""

    def __init__(self, params: Params, db: EncodedDb, pub):
        super().__init__(params, db, pub)
        m = params.num_per * params.n2
        if db.data.shape[-1] % m:
            raise ValueError(f"{db.data.shape[-1]} database columns are not "
                             f"a multiple of num_per*n2 = {m}")
        self.factor = db.data.shape[-1] // m

    def fold(self, cts_coeff, q_pos, q_neg):
        """(F*num_per, n1, n2, 2, d) -> the F survivors: nu_2 rounds (the
        ct axis alone would give log2(F*num_per))."""
        return fold_rounds(cts_coeff, q_pos, q_neg, self.params,
                           num_rounds=self.params.nu_2, g_buf=self._fold_g)

    _response = staticmethod(responses_from_device_rows)

    def process_query_fused(self, query):
        """The serving path (spiral_tpu/factored.py:132-147): expansion,
        composition and conversion first, untimed (on a CUDA server a
        chain of their three graphs); then first dim, fold and modulus
        switch (on a CUDA server one replay of the tail's graph, both
        captured on first use) once warm and once timed on the host clock
        from the staging of its inputs until the rows are on the host.
        -> (list of F Responses, seconds); last_timings holds the tail's
        stages."""
        with tracing.span("serve", request=tracing.count_queries(1)):
            with tracing.span("stage"):
                key, body, sources = self._prepare(
                    "query_stages", [query], self._front, QUERY_STAGES,
                    chain=True)
                self.graphs.stage(key, sources)
            sources = [Staged.whole(t) for t in self.graphs.replay(key, body)]

            def tail():
                return [x[0].cpu() for x in self.graphs.run(
                    ("tail", False, 1), self._tail, sources, TAIL_STAGES)]

            tail()
            t0 = time.perf_counter()
            rows = tail()
            seconds = time.perf_counter() - t0
            return self._response(*rows), seconds

    def process_query_batch(self, queries):
        raise ValueError("a factored server answers one query at a time")


def decode_factored(client: SpiralClient, resps) -> np.ndarray:
    """-> (F, n0, n2, d) item chunks."""
    return np.stack([client.decode(r) for r in resps])
