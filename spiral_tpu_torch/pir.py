"""Spiral PIR client and server on torch (counterpart of spiral_tpu/pir.py),
packed one-ciphertext query on one device.

SpiralServer.process_query runs the stages of the JAX ``full_packed``
pipeline: reconstruct + expansion, composition, conversion, first-dim
multiply + inverse NTT, folding, modulus switch.  On a CUDA device each
stage is timed with CUDA events; on the CPU with the host clock.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .params import Params
from .arith import ntt
from .core.gadget import build_gadget
from .core.poly import sub_raw
from .crypto.decode import (Response, decode_response, modswitch_device,
                            response_from_device_rows)
from .crypto.encrypt import Encryptor
from .crypto.keys import SecretKeys, keygen
from .crypto.publicparams import PublicParams, generate_public_params
from .crypto.query import Query, generate_query, reconstruct_cts
from .server.convert import regev_to_gsw_batch, scal_to_mat_batch
from .server.db import EncodedDb, encode_db, random_db
from .server.expand import coefficient_expansion, reorder_from_stopround
from .server.firstdim import (finish_output, multiply_query_by_db,
                              reorient_query)
from .server.fold import fold_ciphertexts


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
    def total_us(self) -> float:
        return sum(dataclasses.astuple(self))


class StageClock:
    """Stage marks: CUDA events on a CUDA device, else the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_us(self) -> list[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) * 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e6 for a, b in zip(self.marks, self.marks[1:])]


class SpiralServer:
    def __init__(self, params: Params, db: EncodedDb, pub: PublicParams):
        if params.expansion_plan() is not None:
            raise NotImplementedError("only the packed one-ct query form")
        self.params, self.db, self.pub = params, db, pub
        self.device = db.data.device
        d = params.poly_len
        self._g2_ntt = ntt.forward(build_gadget(params.n1, params.m2, d,
                                                self.device))

    # -- stages (spiral_tpu/pir.py _build_stages) --
    def expand(self, seed: int, packed_b: torch.Tensor):
        p = self.params
        packed_ct = reconstruct_cts(seed, packed_b.to(self.device))[0]
        n_gsw = p.t_gsw * p.further_dims
        cv = coefficient_expansion(packed_ct, p.g, self.pub.W_exp_left,
                                   self.pub.W_exp_right, p,
                                   max_bits_to_gen_right=n_gsw,
                                   stopround=p.stopround)
        if p.stopround != 0:
            cv = reorder_from_stopround(cv, p.dim0, n_gsw)
        return cv[:p.dim0], cv[p.dim0:p.dim0 + n_gsw]

    def compose(self, first_scalars):
        return scal_to_mat_batch(first_scalars, self.pub.W_conv, self.params)

    def convert(self, gsw_scalars):
        p = self.params
        gsw = regev_to_gsw_batch(
            gsw_scalars.reshape((p.further_dims, p.t_gsw) +
                                gsw_scalars.shape[1:]),
            self.pub.W_conv, self.pub.V, p)
        q_pos = gsw.flip(0)
        q_neg = sub_raw(self._g2_ntt.expand_as(q_pos), q_pos)
        return q_pos, q_neg

    def first_dim(self, C_reg):
        p = self.params
        res = multiply_query_by_db(self.db.data, reorient_query(C_reg))
        return ntt.inverse(finish_output(res, p.num_per, p.n2))

    def fold(self, cts_coeff, q_pos, q_neg):
        return fold_ciphertexts(cts_coeff, q_pos, q_neg, self.params)

    def process_query(self, query: Query):
        """Answer one query: (Response, ServerTimings)."""
        clock = StageClock(self.device)
        first_scalars, gsw_scalars = self.expand(query.seed, query.packed_b)
        clock.mark()
        C_reg = self.compose(first_scalars)
        clock.mark()
        q_pos, q_neg = self.convert(gsw_scalars)
        clock.mark()
        cts = self.first_dim(C_reg)
        clock.mark()
        final = self.fold(cts, q_pos, q_neg)
        clock.mark()
        first, rest = modswitch_device(final, self.params)
        clock.mark()
        t = clock.intervals_us()
        timings = ServerTimings(
            expansion_us=t[0], composition_us=t[1], conversion_us=t[2],
            first_multiply_us=t[3], folding_us=t[4], modswitch_us=t[5])
        return response_from_device_rows(first, rest), timings


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
