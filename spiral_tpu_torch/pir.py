"""Spiral PIR client and server on torch (counterpart of spiral_tpu/pir.py),
on one device, for both query forms: the packed one-ciphertext query and
SpiralStream's direct upload.

SpiralServer runs the stages of the JAX ``full_packed`` / ``full_direct``
pipelines: reconstruct + expansion, composition, conversion, first-dim
multiply + inverse NTT, folding, modulus switch.  A direct query's cts
are rebuilt from its seed, and a part of the query uploaded as subround
cts is expanded g rounds (``reconstruct_direct``).  It serves them
through serving.Server: _run_single (the JAX one-dispatch
``_run_single``, spiral_tpu/pir.py:353-369, 444-451) and
process_query_fused one query through one CUDA graph of the whole
pipeline, process_query through a chain of CUDA graphs, one per stage
(the JAX stage jits, spiral_tpu/pir.py:344-351), and process_query_batch
a batch of one form (the JAX ``full_packed_batch`` /
``full_direct_batch``) with one replay of the graph for (form, B): the
database streams once per batch (K2 with all B queries' rows) and the
fold is one K5 launch per round.  The server takes an EncodedDb or an
ImplicitDb, whose slab K2 streams num_chunks times.  final_ciphertext,
which stops before the modulus switch, runs eagerly.

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

import numpy as np
import torch

from .params import Params
from .arith import ntt
from .core.gadget import build_gadget
from .crypto.decode import Response, decode_response, modswitch_device
from .crypto.encrypt import Encryptor
from .crypto.keys import SecretKeys, keygen
from .crypto.publicparams import PublicParams, generate_public_params
from .crypto.query import Query, generate_query, reconstruct_cts
from .server.convert import compose_cts, convert_cts, k9_takes
from .dist import shard
from .graphs import no_mark
from .serving import Server, db_tensor, stack_queries
from .serving import ServerTimings  # noqa: F401  (pir.ServerTimings)
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


SPIRAL_STAGES = ("expansion", "composition", "conversion", "first_multiply",
                 "folding", "modswitch")
# under a mesh first dim and fold are one stage (the JAX _stage_serve_db)
SHARDED_STAGES = ("expansion", "composition", "conversion", "serve_db",
                  "modswitch")


class SpiralServer(Server):
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
        super().__init__(self._block.device,
                         SPIRAL_STAGES if mesh is None else SHARDED_STAGES)
        d = params.poly_len
        if self.device.type == "cuda":
            k9_takes(params, d)   # composition and conversion on the card
        self._g2_ntt = ntt.forward(build_gadget(params.n1, params.m2, d,
                                                self.device))
        neg_monomial_ntts(d, self.device)   # made once here
        # G of the fold's K8b rounds (2.2 GB at spiral_24_256), so that no
        # query allocates it
        self._fold_g = mxu_workspace(params, self.device)

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

    def _front(self, seeds, bs, direct: bool, mark=no_mark):
        """Expansion, composition and conversion of a batch (its seeds or
        seed_words and b rows (B, n, 1, 1, 2, d)), `mark` called after
        each: C_reg_b, q_pos_b, q_neg_b."""
        first_b, gsw_b = self._scalars(seeds, bs, direct)
        mark()
        C_reg_b = self.compose(first_b)
        mark()
        q_pos_b, q_neg_b = self.convert(gsw_b)
        mark()
        return C_reg_b, q_pos_b, q_neg_b

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

    def _end(self, finals, mark=no_mark):
        """The modulus switch, `mark` called after it: the rows (B, 1, cols,
        d) and (B, rows - 1, cols, d) on the device."""
        rows = modswitch_device(finals, self.params)
        mark()
        return rows

    @staticmethod
    def encode_database(pts: np.ndarray, params: Params,
                        device="cuda") -> EncodedDb:
        return encode_db(pts, params, torch.device(device))

    def final_ciphertext(self, query: Query) -> torch.Tensor:
        """The folded ct before the modulus switch, (n1, n2, 2, d)
        coefficient domain: the error-analysis hook (ref: --output-err,
        src/spiral.cpp:1517-1535)."""
        return self._middle(*self._front(*stack_queries([query],
                                                        self.device)))[0]

    def process_query_batch(self, queries: list[Query]):
        """Server.process_query_batch; a sharded batch over an implicit
        database raises ValueError (the JAX mesh server's batch multiplies
        the slab once and raises a TypeError there)."""
        if self.mesh is not None and isinstance(self.db, ImplicitDb):
            raise ValueError("a sharded batch over an implicit database is "
                             "not supported")
        return super().process_query_batch(queries)


def serve_single(server: Server, query: Query):
    """One query served by any server's _run_single: on a CUDA server one
    replay of the graph of the query's form (captured on first use), on a
    CPU server the same staged runner run eagerly.  -> fresh response rows
    on the device."""
    return server._run_single(query)


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
