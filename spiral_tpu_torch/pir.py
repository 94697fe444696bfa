"""Spiral PIR client and server on torch (counterpart of spiral_tpu/pir.py),
on one device, for both query forms: the packed one-ciphertext query and
SpiralStream's direct upload.

SpiralServer.process_query runs the stages of the JAX ``full_packed`` /
``full_direct`` pipelines: reconstruct + expansion, composition,
conversion, first-dim multiply + inverse NTT, folding, modulus switch.  A
direct query's cts are rebuilt from its seed, and a part of the query
uploaded as subround cts is expanded g rounds (``reconstruct_direct``).
As the JAX server runs each stage as its own jitted program
(spiral_tpu/pir.py:344-351), a CUDA server runs them as a chain of CUDA
graphs, one per stage (graphs.GraphRunner, key ("stages", form, 1)),
each stage timed by CUDA events recorded between the replays: its
graph's device time and one launch.  On the CPU the same chain runs
eagerly under the host clock.  ``last_timings`` gives the stage times of
a server's last served call, whichever path served it.
process_query_batch runs the same stages over a batch of queries of one
form (the JAX ``full_packed_batch`` / ``full_direct_batch``): the
database streams once per batch (K2 with all B queries' rows) and the
fold is one K5 launch per round.  The server takes an EncodedDb or an
ImplicitDb, whose slab K2 streams num_chunks times.

_run_single is the serving path (the JAX one-dispatch ``_run_single``,
spiral_tpu/pir.py:353-369, 444-451): on a CUDA server one replay of a
CUDA graph of the whole pipeline, captured on the server's first call for
the query's form (graphs.GraphRunner: the seed's key words and the b rows
staged into its static inputs, fresh response rows cloned from its
outputs); on a CPU server the same staged runner runs the stages
eagerly.  process_query_fused serves a query twice through it and times
the second run on the host until the response rows are on the host;
process_query_batch serves a batch of B with one replay of the graph for
(form, B) (the JAX ``full_*_batch``).  Each graph of a whole path records
its stage events inside it (graphs.py), so every replay is split by stage
on the card's clock.  final_ciphertext, which stops before
the modulus switch, runs eagerly, and so does _run_eager, the eager
reference of every served path.  A server's graphs live as long as it
does, or until release_graphs().

With ``mesh`` (a torch.distributed DeviceMesh with a "db" dimension,
dist/shard.py) the database is row-sharded: each rank streams its column
block through K2, folds its rows to one survivor, and after one
all-gather every rank folds the tail and switches the modulus, so every
rank holds the response (the JAX mesh server, spiral_tpu/pir.py:98-156,
223-306).  An EncodedDb must fit on each card: the server cuts this
rank's block from it and keeps only the block (as ``self.db``, a
ShardedDb), so the full tensor is freed once the caller drops it;
multihost.ingest_and_serve never holds more than the block.  An implicit
slab is replicated instead and each rank streams its share of the
chunks.  First dim and fold are then one stage, timed as
first_multiply_us with folding_us 0, as the JAX mesh server reports them.
A mesh server serves through the same graphs (the JAX package jits its
sharded step, spiral_tpu/dist/shard.py:142): on NCCL the all-gather is
captured inside them, its communicator made by the warm run before the
first capture, and every rank captures and replays the same graphs in
the same order.  gloo collectives cannot be captured, so on the CPU a
mesh server runs the same runner eagerly.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .params import Params
from .arith import ntt
from .core.gadget import build_gadget
from .crypto.decode import (Response, decode_response, modswitch_device,
                            response_from_device_rows,
                            responses_from_device_rows)
from .crypto.encrypt import Encryptor
from .crypto.keys import SecretKeys, keygen
from .crypto.publicparams import PublicParams, generate_public_params
from .crypto.query import (Query, generate_query, reconstruct_cts,
                           seed_words)
from .server.convert import compose_cts, convert_cts, k9_takes
from . import tracing
from .dist import shard
from .graphs import GraphRunner, StageClock, Staged, no_mark, static_inputs
from .server.db import (EncodedDb, ImplicitDb, ShardedDb, encode_db,
                        random_db)
from .server.expand import (coefficient_expansion, neg_monomial_ntts,
                            reorder_from_stopround)
from .server.firstdim import (finish_output_batch, multiply_query_by_db_batch,
                              reorient_query)
from .server.fold import (fold_ciphertexts, fold_rounds_batch,
                          mxu_workspace)


class SpiralClient:
    def __init__(self, params: Params, seed: int = 0, device="cuda",
                 nonoise: bool = False):
        self.params = params
        self.device = torch.device(device)
        self.gen = torch.Generator().manual_seed(seed)
        self.keys: SecretKeys = keygen(params, self.gen, self.device,
                                       nonoise=nonoise)
        self.enc = Encryptor(self.keys, params.poly_len, self.gen,
                             nonoise=nonoise)

    def setup(self) -> PublicParams:
        return generate_public_params(self.params, self.enc)

    def query(self, idx: int) -> Query:
        return generate_query(self.params, self.enc, idx)

    def decode(self, resp: Response) -> np.ndarray:
        """(n0, n2, d) plaintext matrix mod p_db."""
        return decode_response(resp, self.keys.Sp_centered, self.params)


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


SPIRAL_STAGES = ("expansion", "composition", "conversion", "first_multiply",
                 "folding", "modswitch")
# under a mesh first dim and fold are one stage (the JAX _stage_serve_db)
SHARDED_STAGES = ("expansion", "composition", "conversion", "serve_db",
                  "modswitch")


def serve_fused(server, query: Query):
    """A server's process_query_fused: one warm run of
    ``server._run_single`` (the first for the query's form captures its
    graph), then a second timed on the host clock from the staging of its
    inputs until the response rows are on the host.  -> (the server's
    response, seconds)."""
    for x in server._run_single(query):
        x.cpu()
    t0 = time.perf_counter()
    rows = [x.cpu() for x in server._run_single(query)]
    seconds = time.perf_counter() - t0
    return server._response(*rows), seconds


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


class SpiralServer:
    def __init__(self, params: Params,
                 db: EncodedDb | ImplicitDb | ShardedDb, pub: PublicParams,
                 mesh=None):
        self.params, self.db, self.pub, self.mesh = params, db, pub, mesh
        self.num_chunks = db.num_chunks if isinstance(db, ImplicitDb) else 1
        # what K2 streams on this rank: its tensor, chunks and first chunk
        self._block, self._chunks, self._first_chunk = \
            db_tensor(db), self.num_chunks, 0
        if isinstance(db, ShardedDb) and mesh is None:
            raise ValueError("ShardedDb requires a mesh")
        if mesh is not None:
            self._group, world, rank = shard.db_axis(mesh)
            if isinstance(db, ImplicitDb):
                if db.num_chunks % world:
                    raise ValueError(
                        f"implicit num_chunks {db.num_chunks} not divisible "
                        f"by mesh size {world}")
                self._chunks = db.num_chunks // world
                self._first_chunk = rank * self._chunks
            elif isinstance(db, EncodedDb):
                # the rank keeps its block only
                self._block = shard.shard_db_rows(db.data, params.num_per,
                                                  mesh)
                self.db = ShardedDb(self._block, params, mesh)
        self.device = self._block.device
        d = params.poly_len
        if self.device.type == "cuda":
            k9_takes(params, d)   # composition and conversion on the card
        self._g2_ntt = ntt.forward(build_gadget(params.n1, params.m2, d,
                                                self.device))
        neg_monomial_ntts(d, self.device)   # made once here
        # G of the fold's K8b rounds (2.2 GB at spiral_24_256), so that no
        # query allocates it
        self._fold_g = mxu_workspace(params, self.device)
        self.graphs = GraphRunner(self.device, type(self).__name__)
        self.stages = SPIRAL_STAGES if mesh is None else SHARDED_STAGES

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
        clock of its eager run.  Read lazily: reading syncs on the events,
        and the value holds until the next served call.  None before the
        first."""
        key = self.graphs.last
        return None if key is None else self._stage_times(
            key, self.graphs.programs[key].clock)

    def _stage_times(self, key: tuple, clock: StageClock) -> ServerTimings:
        """The ServerTimings of `key`'s clock."""
        return _timings(clock, self.mesh is not None)

    # -- stages (spiral_tpu/pir.py _build_stages); the *_batch forms,
    # compose and convert take and give a leading query axis, as the JAX
    # batch's jax.vmap does --
    def expand_batch(self, seeds: list[int], packed_bs: torch.Tensor):
        """seeds (or their query.seed_words) and b rows (B, 1, 1, 1, 2, d)
        -> first-dimension scalars (B, dim0, 2, 1, 2, d) and GSW sources
        (B, nu_2*t_gsw, ...)."""
        p = self.params
        packed_ct = reconstruct_cts(seeds, packed_bs.to(self.device))[:, 0]
        n_gsw = p.t_gsw * p.further_dims
        cv = coefficient_expansion(packed_ct, p.g, self.pub.W_exp_left,
                                   self.pub.W_exp_right, p,
                                   max_bits_to_gen_right=n_gsw,
                                   stopround=p.stopround)
        if p.stopround != 0:
            cv = reorder_from_stopround(cv, p.dim0, n_gsw)
        return cv[:, :p.dim0], cv[:, p.dim0:p.dim0 + n_gsw]

    def reconstruct_direct_batch(self, seeds: list[int], bs: torch.Tensor):
        """Direct queries' seeds and b rows (B, n_first + n_rest, 1, 1, 2,
        d) -> first-dimension scalars and GSW sources, as expand_batch
        gives them (the JAX reconstruct_direct, pir.py:311-334): the (-a,
        b) cts rebuilt from the seeds, each part as uploaded if direct,
        else each of its cts expanded g rounds with W[:g] and its first
        `bits` slots kept (on the card K8a and K4, the part's cts of all
        B queries as one batch)."""
        p = self.params
        plan = p.expansion_plan()
        cts = reconstruct_cts(seeds, bs.to(self.device))
        n_first = plan["first"]["n_cts"]
        return (self._expand_part(cts[:, :n_first], plan["first"]),
                self._expand_part(cts[:, n_first:], plan["rest"]))

    def _expand_part(self, cts, part: dict):
        """(B, n_cts, 2, 1, 2, d) -> (B, n_cts * bits, 2, 1, 2, d)."""
        if part["direct"]:
            return cts
        g, bits = part["g"], part["bits"]
        B, n = cts.shape[:2]
        ex = coefficient_expansion(cts.flatten(0, 1), g,
                                   self.pub.W_exp_left[:g],
                                   self.pub.W_exp_right[:g], self.params)
        return ex[:, :bits].reshape((B, n * bits) + cts.shape[2:])

    def query_scalars_batch(self, queries: list[Query]):
        """The expansion stage of a batch of one form: its first-dimension
        scalars (B, dim0, 2, 1, 2, d) and GSW sources (B, nu_2*t_gsw, 2,
        1, 2, d)."""
        return self._scalars(*stack_queries(queries, self.device))

    def _scalars(self, seeds, bs: torch.Tensor, direct: bool):
        """query_scalars_batch on the batch's seeds (or their seed_words)
        and b rows."""
        if direct:
            return self.reconstruct_direct_batch(seeds, bs)
        return self.expand_batch(seeds, bs)

    def compose(self, first_scalars):
        """([B,] dim0, 2, 1, 2, d) -> ([B,] dim0, n1, n0, 2, d): one K9
        launch on the card."""
        return compose_cts(first_scalars, self.pub.W_conv, self.params)

    def convert(self, gsw_scalars):
        """([B,] nu_2*t_gsw, 2, 1, 2, d) -> q_pos, q_neg ([B,] nu_2, n1, m2,
        2, d): one K9 launch on the card."""
        return convert_cts(gsw_scalars, self.pub.W_conv, self.pub.V,
                           self._g2_ntt, self.params)

    def first_dim_batch(self, C_reg_b):
        """(B, dim0, n1, n0, 2, d) -> (B, num_per, n1, n2, 2, d) coeff: K2
        streams the database (or the slab, num_chunks times) once for the
        batch; under a mesh this rank's block (or chunks) and its
        num_per / world rows."""
        n2 = self.params.n2
        res = multiply_query_by_db_batch(self._block,
                                         reorient_query(C_reg_b),
                                         self._chunks, self._first_chunk)
        # the columns' cts: num_per (F*num_per over a factored database)
        return ntt.inverse(finish_output_batch(res, res.shape[-1] // n2, n2))

    def first_dim(self, C_reg):
        return self.first_dim_batch(C_reg[None])[0]

    def fold_batch(self, cts_b, q_pos_b, q_neg_b):
        """-> the survivors (B, n1, n2, 2, d), coeff: one K5 launch per
        round (under a mesh shard.fold_sharded_batch)."""
        if self.mesh is not None:
            return shard.fold_sharded_batch(cts_b, q_pos_b, q_neg_b,
                                            self.params, self._group)
        return fold_rounds_batch(cts_b, q_pos_b, q_neg_b, self.params)[:, 0]

    def fold(self, cts_coeff, q_pos, q_neg):
        """-> the survivor (n1, n2, 2, d), coeff (under a mesh
        shard.fold_sharded: this rank's rows, then the replicated tail)."""
        if self.mesh is not None:
            return shard.fold_sharded(cts_coeff, q_pos, q_neg, self.params,
                                      self._group, self._fold_g)
        return fold_ciphertexts(cts_coeff, q_pos, q_neg, self.params,
                                g_buf=self._fold_g)

    @staticmethod
    def encode_database(pts: np.ndarray, params: Params,
                        device="cuda") -> EncodedDb:
        return encode_db(pts, params, torch.device(device))

    def _query_stages(self, seeds, bs, direct: bool, mark=no_mark):
        """Expansion, composition and conversion of one query (its seeds or
        seed_words and b rows (1, n, 1, 1, 2, d)), `mark` called after
        each: C_reg, q_pos, q_neg."""
        first_b, gsw_b = self._scalars(seeds, bs, direct)
        mark()
        C_reg = self.compose(first_b[0])
        mark()
        q_pos, q_neg = self.convert(gsw_b[0])
        mark()
        return C_reg, q_pos, q_neg

    def _final(self, seeds, bs, direct: bool, mark=no_mark) -> torch.Tensor:
        """The stages of one query up to the fold, `mark` called after each
        (first dim and fold one stage under a mesh): the folded ct,
        coefficient domain."""
        C_reg, q_pos, q_neg = self._query_stages(seeds, bs, direct, mark)
        cts = self.first_dim(C_reg)
        if self.mesh is None:
            mark()
        final = self.fold(cts, q_pos, q_neg)
        mark()
        return final

    def _rows(self, seeds, bs, direct: bool, mark=no_mark):
        """Every stage of one query: the response rows on the device."""
        rows = modswitch_device(self._final(seeds, bs, direct, mark),
                                self.params)
        mark()
        return rows

    def _batch_rows(self, seeds, bs, direct: bool, mark=no_mark):
        """Every stage of a batch (its seeds or seed_words and b rows (B,
        n, 1, 1, 2, d)), `mark` called after each: the rows (B, 1, n2, d)
        and (B, n1 - 1, n2, d) on the device."""
        first_b, gsw_b = self._scalars(seeds, bs, direct)
        mark()
        C_reg_b = self.compose(first_b)
        mark()
        q_pos_b, q_neg_b = self.convert(gsw_b)
        mark()
        cts_b = self.first_dim_batch(C_reg_b)
        if self.mesh is None:
            mark()
        finals = self.fold_batch(cts_b, q_pos_b, q_neg_b)
        mark()
        rows = modswitch_device(finals, self.params)
        mark()
        return rows

    def _run_eager(self, query: Query, mark=no_mark):
        """Every stage of one query, enqueued eagerly, `mark` called after
        each: the response rows on the device."""
        return self._rows(*stack_queries([query], self.device), mark)

    def _run_batch(self, queries: list[Query], mark=no_mark):
        """Every stage of a batch, enqueued eagerly: its rows."""
        return self._batch_rows(*stack_queries(queries, self.device), mark)

    def _run_single(self, query: Query):
        """One query served (serve_single): fresh response rows on the
        device."""
        return serve_single(self, query)

    _response = staticmethod(response_from_device_rows)

    def final_ciphertext(self, query: Query) -> torch.Tensor:
        """The folded ct before the modulus switch, (n1, n2, 2, d)
        coefficient domain: the error-analysis hook (ref: --output-err,
        src/spiral.cpp:1517-1535)."""
        return self._final(*stack_queries([query], self.device))

    def process_query(self, query: Query):
        """Answer one query of either form: (Response, ServerTimings), the
        stages timed one by one (serve_stages).  A direct query's
        reconstruction (and any part's expansion) is timed as its
        expansion_us; the JAX server leaves that field at 0 for direct
        queries, the time falling into its composition."""
        rows = serve_stages(self, query)
        return self._response(*rows), self.last_timings

    def process_query_fused(self, query: Query):
        """The serving path: (Response, seconds), the seconds of a second
        run (serve_fused) until the response rows are on the host."""
        return serve_fused(self, query)

    def process_query_batch(self, queries: list[Query]):
        """Answer a batch of queries of one form: (list[Response], seconds),
        the window from the staging of the batch (a mesh server: its first
        stage) until the response rows are on the host.  A CUDA server
        serves it with one replay of the graph for (form, B), captured on
        first use; its stage times are ``last_timings``.  A mixed batch
        raises ValueError, and so does a sharded batch over an implicit
        database (the JAX mesh server's batch multiplies the slab once and
        raises a TypeError there)."""
        if self.mesh is not None and isinstance(self.db, ImplicitDb):
            raise ValueError("a sharded batch over an implicit database is "
                             "not supported")
        return serve_batch(self, queries)


def stage_queries(server, path: str, queries: list[Query], rows,
                  stages: tuple | None = None, chain: bool = False):
    """Stage a served call of `path` (span "stage"): the queries' inputs
    (query_sources), the program of (path, form, B) made on first use
    (graphs.GraphRunner.prepare) and the inputs' copies.  rows(words, bs,
    direct, mark) is the path's body; stages default to server.stages.
    -> (the program's key, its body)."""
    with tracing.span("stage"):
        direct, sources = query_sources(queries)
        key = (path, direct, len(queries))

        def body(words, bs, mark):
            return rows(words, bs, direct, mark)

        server.graphs.prepare(key, body, sources,
                              server.stages if stages is None else stages,
                              chain=chain)
        server.graphs.stage(key, sources)
    return key, body


def serve_single(server, query: Query):
    """A server's _run_single: on a CUDA server one replay of the graph of
    the query's form (captured on first use), on a CPU server the same
    staged runner run eagerly.  -> fresh response rows on the device."""
    with tracing.span("serve", request=tracing.count_queries(1)):
        key, body = stage_queries(server, "single", [query], server._rows)
        return server.graphs.replay(key, body)


def serve_stages(server, query: Query):
    """A server's process_query: the chain of server.stages for the
    query's form (captured on first use; on a CPU server run eagerly),
    its inputs staged, then replayed with a StageClock marked after each
    stage (last_timings).  -> fresh response rows on the device."""
    with tracing.span("serve", request=tracing.count_queries(1)):
        key, body = stage_queries(server, "stages", [query], server._rows,
                                  chain=True)
        return server.graphs.replay(key, body)


def serve_batch(server, queries: list[Query]
                ) -> tuple[list[Response], float]:
    """A server's process_query_batch: (responses, seconds) from the
    staging's copies until the responses are on the host, through the
    GraphRunner (on a CUDA server one replay of the graph for (form, B),
    captured on first use).  The stage times are last_timings."""
    with tracing.span("serve", request=tracing.count_queries(len(queries))):
        with tracing.span("stage"):
            direct, sources = query_sources(queries)
            key = ("batch", direct, len(queries))

            def body(words, bs, mark):
                return server._batch_rows(words, bs, direct, mark)

            server.graphs.prepare(key, body, sources, server.stages)
            t0 = time.perf_counter()
            server.graphs.stage(key, sources)
        responses = responses_from_device_rows(*server.graphs.replay(key,
                                                                     body))
        return responses, time.perf_counter() - t0


def _timings(clock: StageClock, sharded: bool = False) -> ServerTimings:
    """The six Spiral stage intervals of a StageClock, or its five where
    first dim and fold were one sharded stage (folding_us 0)."""
    t = clock.intervals_us()
    if sharded:
        t.insert(4, 0.0)
    return ServerTimings(expansion_us=t[0], composition_us=t[1],
                         conversion_us=t[2], first_multiply_us=t[3],
                         folding_us=t[4], modswitch_us=t[5])


def run_pir(params: Params, idx: int | None = None, seed: int = 0,
            nonoise: bool = False, rng: np.random.Generator | None = None,
            device="cuda"):
    """Self-checking end-to-end run: (correct, timings, client, server)."""
    rng = rng or np.random.default_rng(seed)
    idx = int(rng.integers(0, params.total_n)) if idx is None else idx
    client = SpiralClient(params, seed=seed, device=device, nonoise=nonoise)
    pub = client.setup()
    pts = random_db(params, rng)
    server = SpiralServer(params, encode_db(pts, params,
                                            torch.device(device)), pub)
    resp, timings = server.process_query(client.query(idx))
    correct = bool(np.array_equal(client.decode(resp),
                                  pts[idx].astype(object)))
    return correct, timings, client, server
