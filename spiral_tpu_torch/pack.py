"""SpiralPack and SpiralStreamPack, the high-rate variant, on torch
(counterpart of spiral_tpu/pack.py; ref: src/testing.cpp:777-1155
testHighRate), on one device.

The scheme runs out_n^2 scalar-Regev PIR pipelines ("trials") over 1 x 1
poly records as one batched program and packs the out_n^2 result cts into
one (out_n+1) x out_n matrix ct before the two-modulus switch.
PackServer runs: expansion (K1, K8a, K4), conversion to GSW
(``regev_to_simple_gsw``), the first-dimension multiply with n1 = 2 query
rows (K2) and its inverse NTT, the unsigned fold rounds (K6), packing (K7)
and its inverse NTT, and the modulus switch, and serves them through
serving.Server as pir.py's servers do: process_query as a chain of CUDA
graphs, one per stage (the JAX stage jits, spiral_tpu/pack.py:467-473),
_run_single and process_query_fused as one CUDA graph of the whole
pipeline (the JAX ``_run_single`` chains its stage jits with no sync,
spiral_tpu/pack.py:604-625), and process_query_batch (the JAX
``full_packed_batch``, pack.py:501-536) with one replay of the graph for
(form, B): K2 streams the database once for all queries, the fold is one
K5 launch per round and K7 one launch.  The server takes an EncodedDb or
an ImplicitDb (served one query at a time, as in the JAX package).  With
``mesh`` (dist/shard.py) an encoded database is row-sharded over its
(trial, position) columns: each rank keeps only its column block (a
ShardedDb) and streams it through K2, the K2 outputs are gathered along
the column axis, and fold (K6) and pack (K7) run replicated on every rank
(spiral_tpu/pack.py:328-363, 409-425), served through the same graphs as
an unsharded server (on NCCL the all-gather captured inside them); an
implicit database with a mesh raises ValueError, as in the JAX package.

Where ``direct_upload_first`` holds (SpiralStreamPack) the client uploads
every ct directly: dim0 first-dimension scalars, then for each GSW digit
value val the pair (sr*val, val), which the server lays out as a GSW ct's
columns 2j and 2j+1 (``conv_direct``) with no expansion and no V.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .params import LOG_Q, Params, get_bits_per
from .arith import ntt
from .arith.crt import const_residues, residues_from_values
from .core.gadget import build_gadget, gadget_invert_raw
from .core.poly import matmul_raw, scalar_mul_raw, sub_raw
from .crypto.decode import Response, decode_response, modswitch_device
from .crypto.encrypt import Encryptor
from .crypto.keys import SecretKeys, keygen
from .crypto.publicparams import (expansion_keyswitch_matrices,
                                  matrix_bytes)
from .crypto.query import (Query, encrypt_b_batch, gsw_digit_values,
                           new_seed, packed_query, reconstruct_cts,
                           sigmas_ntt)
from .dist import shard
from .graphs import no_mark
from .serving import Server, db_tensor, stack_queries
from .server import db as db_mod
from .server.db import EncodedDb, ImplicitDb, bitrev_perm
from .server.expand import coefficient_expansion, neg_monomial_ntts
from .server.firstdim import multiply_query_by_db_batch
from .server.fold import fold_pack_rounds, fold_pack_rounds_batch
from .server.pack import pack_ciphertexts


PACK_STAGES = ("expansion", "conversion", "first_multiply", "folding",
               "packing", "modswitch")


def pack_g_stop(params: Params) -> tuple[int, int]:
    """Expansion depth for the pack variant (ref: testing.cpp:797-799):
    stopround is used unconditionally."""
    ell = params.t_gsw
    num_bits = ell * params.further_dims + params.dim0
    g = max(1, math.ceil(math.log2(num_bits)))
    stop = max(1, math.ceil(math.log2(ell * params.further_dims)))
    return g, stop


@dataclasses.dataclass
class PackPublicParams:
    """W_exp_* and V are None where the query is uploaded directly."""
    v_W: torch.Tensor      # (out_n, out_n+1, m_conv, 2, d) packing keys, NTT
    W_exp_left: list | None    # g tensors (2, m_exp, 2, d), NTT
    W_exp_right: list | None   # stop+1 tensors (2, m_exp_right, 2, d), NTT
    V: torch.Tensor | None     # (2, 2*m_conv, 2, d) conversion key, NTT
    size_bytes: int = 0        # the JAX accounting; the wire size from bytes


def generate_pack_public_params(params: Params, enc: Encryptor
                                ) -> PackPublicParams:
    """spiral_tpu/pack.py _pack_setup_inner: v_W[r] = Enc_S(row r = sr*g),
    expansion keys over g and stop+1 rounds, and V, whose column 2k is
    Enc_sr(sr^2 z^k) and column 2k+1 Enc_sr(sr z^k) (ref:
    testing.cpp:917-943).  With direct_upload_first only v_W is made
    (pack.py:86-105, :119-138).  size_bytes is the JAX PackClient.setup's
    accounting (pack.py:119-137): out_n*(out_n+1)*m_conv polys of v_W, and
    where the query is expanded the W_exp_* and 2*2*m_conv polys of V, d
    56-bit coefficients each."""
    d, dev = params.poly_len, enc.device
    out_n, m_conv = params.out_n, params.m_conv
    sr_ntt = ntt.forward(enc.keys.sr)[0, 0]
    s0g = scalar_mul_raw(sr_ntt, ntt.forward(build_gadget(1, m_conv, d, dev)))
    v_W = []
    for r in range(out_n):
        AG = torch.zeros((out_n, m_conv, 2, d), dtype=torch.int32, device=dev)
        AG[r] = s0g[0]
        v_W.append(enc.encrypt_matrix(AG))
    size = out_n * (out_n + 1) * m_conv * d * LOG_Q // 8
    if params.direct_upload_first:
        return PackPublicParams(v_W=torch.stack(v_W), W_exp_left=None,
                                W_exp_right=None, V=None, size_bytes=size)
    g, stop = pack_g_stop(params)
    W_left = expansion_keyswitch_matrices(enc, g, params.m_exp, d)
    W_right = expansion_keyswitch_matrices(enc, stop + 1,
                                           params.m_exp_right, d)
    bits = get_bits_per(m_conv)
    bases = (scalar_mul_raw(sr_ntt, sr_ntt), sr_ntt)
    sigmas = []
    for i in range(2 * m_conv):
        z = torch.tensor(const_residues(1 << (bits * (i // 2))),
                         device=dev)[:, None]
        sigmas.append(scalar_mul_raw(z, bases[i % 2]))
    # one simple-Regev ct per column: independent a and e for each
    V = enc.encrypt_simple_regev_matrix(torch.stack(sigmas)[None])
    size += sum(map(matrix_bytes, W_left + W_right)) + \
        2 * 2 * m_conv * d * LOG_Q // 8
    return PackPublicParams(v_W=torch.stack(v_W), W_exp_left=W_left,
                            W_exp_right=W_right, V=V, size_bytes=size)


class PackClient:
    def __init__(self, params: Params, seed: int = 0, device="cuda",
                 nonoise: bool = False):
        self.params = params
        self.device = torch.device(device)
        self.gen = torch.Generator().manual_seed(seed)
        self.keys: SecretKeys = keygen(params, self.gen, self.device,
                                       n_val=params.out_n, k=1,
                                       nonoise=nonoise)
        self.enc = Encryptor(self.keys, params.poly_len, self.gen,
                             nonoise=nonoise)

    def setup(self) -> PackPublicParams:
        return generate_pack_public_params(self.params, self.enc)

    def query(self, idx: int) -> Query:
        """The packed ct, or with direct_upload_first the direct form
        (stream_pack_sigmas, all from one seed)."""
        p = self.params
        if not p.direct_upload_first:
            return packed_query(p, self.enc, idx, *pack_g_stop(p))
        seed = new_seed(self.enc)
        sig = stream_pack_sigmas(p, idx, ntt.forward(self.keys.sr)[0, 0])
        b = encrypt_b_batch(self.enc, seed, sig)
        return Query(seed=seed, first_b=b[:p.dim0], gsw_b=b[p.dim0:],
                     size_bytes=sig.shape[0] * p.bytes_per_poly)

    def decode(self, resp: Response) -> np.ndarray:
        """(out_n, out_n, d) plaintext matrix mod p_db."""
        return decode_response(resp, self.keys.Sp_centered, self.params)


def stream_pack_sigmas(params: Params, idx: int, sr_ntt: torch.Tensor
                       ) -> torch.Tensor:
    """The plaintexts of a SpiralStreamPack query (pack.py:169-185; ref:
    testing.cpp:969-979), NTT (dim0 + 2*nu_2*t_gsw, 1, 1, 2, d): dim0
    constants, scale_k at idx's first-dimension row and 0 elsewhere, then
    for each GSW digit value val (gsw_digit_values) sr*val and the
    constant val.  sr_ntt: the secret sr, NTT (2, d)."""
    vals = gsw_digit_values(params, idx)
    polys = np.zeros((params.dim0 + len(vals), params.poly_len),
                     dtype=object)
    polys[idx // params.num_per, 0] = params.scale_k
    polys[params.dim0:, 0] = vals
    consts = sigmas_ntt(polys, sr_ntt.device)
    z = torch.tensor([const_residues(v) for v in vals],
                     device=sr_ntt.device)[:, :, None]
    pairs = torch.stack([scalar_mul_raw(sr_ntt, z),
                         consts[params.dim0:, 0, 0]], dim=1)
    return torch.cat([consts[:params.dim0],
                      pairs.reshape(-1, 1, 1, 2, params.poly_len)])


def random_pack_db(params: Params, rng: np.random.Generator) -> np.ndarray:
    """Host plaintexts (total_n, out_n, out_n, d) in [0, p_db)."""
    return rng.integers(
        0, params.p_db,
        size=(params.total_n, params.out_n, params.out_n, params.poly_len),
        dtype=np.int64)


def encode_pack_db(pts: np.ndarray, params: Params, device) -> EncodedDb:
    """Center mod p_db, lift, NTT on `device`, and write K2's layout

        data[limb, z, j, t*num_per + pos]     (2, d, K = dim0, T*num_per)

    for record j*num_per + bitrev(pos), trial t = r*out_n + c holding its
    (r, c) poly (spiral_tpu/pack.py encode_pack_db's (T, num_per, 1, dim0,
    2, d), transposed as server/db.py lays out Spiral's), one block of
    first-dimension rows at a time."""
    p_db, d = params.p_db, params.poly_len
    num_per, dim0, T = params.num_per, params.dim0, params.out_n ** 2
    small = np.int16 if p_db <= (1 << 15) else np.int32
    perm = torch.from_numpy(bitrev_perm(num_per)).to(device)
    out = torch.empty((2, d, dim0, T * num_per), dtype=torch.int32,
                      device=device)
    jb = max(1, min(dim0, db_mod.BLOCK_POLYS // (num_per * T)))
    for j0 in range(0, dim0, jb):
        j1 = min(dim0, j0 + jb)
        block = pts[j0 * num_per:j1 * num_per]
        centered = np.where(block >= p_db // 2, block - p_db, block)
        c = torch.from_numpy(centered.astype(small)).to(device).long()
        t = ntt.forward(residues_from_values(c))   # (nb*num_per, on, on, 2, d)
        t = t.reshape(j1 - j0, num_per, T, 2, d)[:, perm]
        out[:, :, j0:j1] = t.permute(3, 4, 0, 2, 1).reshape(
            2, d, j1 - j0, T * num_per)
    return EncodedDb(data=out, params=params)


def regev_to_simple_gsw(cv: torch.Tensor, V: torch.Tensor,
                        params: Params) -> torch.Tensor:
    """cv (..., nu_2*t_gsw, 2, 1, 2, d) NTT scalar cts -> (..., nu_2, 2,
    2*t_gsw, 2, d) GSW cts, column 2j holding V . G^{-1}(ct j) and column
    2j+1 ct j (ref: testing.cpp:108-140); a leading query axis as jax.vmap
    gives it."""
    ell, d = params.t_gsw, params.poly_len
    lead = cv.shape[:-5]
    ginv = ntt.forward(gadget_invert_raw(ntt.inverse(cv), 2 * params.m_conv,
                                         2))
    tmp = matmul_raw(V, ginv)                  # (..., nu2*ell, 2, 1, 2, d)
    pair = torch.stack([tmp[..., 0, :, :], cv[..., 0, :, :]], dim=-3)
    return pair.reshape(lead + (params.further_dims, ell, 2, 2, 2, d)) \
        .transpose(-5, -4).reshape(lead + (params.further_dims, 2, 2 * ell,
                                           2, d))


class PackServer(Server):
    def __init__(self, params: Params, db: EncodedDb | ImplicitDb,
                 pub: PackPublicParams, mesh=None):
        self.params, self.db, self.pub, self.mesh = params, db, pub, mesh
        # what K2 streams on this rank
        self._block = db_tensor(db)
        if mesh is not None:
            if isinstance(db, ImplicitDb):
                raise ValueError("implicit pack DB does not support mesh")
            self._group = shard.db_axis(mesh)[0]
            self._block = shard.shard_db_rows(
                db.data, params.out_n ** 2 * params.num_per, mesh)
            self.db = db_mod.ShardedDb(self._block, params, mesh)
        super().__init__(self._block.device, PACK_STAGES)
        self.num_chunks = db.num_chunks if isinstance(db, ImplicitDb) else 1
        self._g_ntt = ntt.forward(build_gadget(2, 2 * params.t_gsw,
                                               params.poly_len, self.device))
        neg_monomial_ntts(params.poly_len, self.device)   # made once here

    # -- stages (spiral_tpu/pack.py PackServer._build_stages); the *_batch
    # forms, convert and pack take and give a leading query axis --
    def expand_batch(self, seeds: list[int], packed_bs: torch.Tensor):
        """Even slots feed the first dimension, odd slots the GSW sources:
        (B, dim0, 2, 1, 2, d) and (B, nu_2*t_gsw, 2, 1, 2, d)."""
        p = self.params
        packed_ct = reconstruct_cts(seeds, packed_bs.to(self.device))[:, 0]
        g, stop = pack_g_stop(p)
        n_gsw = p.t_gsw * p.further_dims
        cv = coefficient_expansion(packed_ct, g, self.pub.W_exp_left,
                                   self.pub.W_exp_right, p,
                                   max_bits_to_gen_right=n_gsw,
                                   stopround=stop)
        return cv[:, 0::2][:, :p.dim0], cv[:, 1::2][:, :n_gsw]

    def reconstruct_direct_batch(self, seeds: list[int], bs: torch.Tensor):
        """Direct queries' seeds and b rows (B, dim0 + 2*nu_2*t_gsw, 1, 1,
        2, d) -> their (-a, b) cts, split into the first-dimension scalars
        (B, dim0, 2, 1, 2, d) and the GSW pairs (B, 2*nu_2*t_gsw, 2, 1, 2,
        d) (pack.py reconstruct_direct)."""
        cts = reconstruct_cts(seeds, bs.to(self.device))
        return cts[:, :self.params.dim0], cts[:, self.params.dim0:]

    def convert(self, gsw_src):
        """([B,] nu_2*t_gsw, 2, 1, 2, d) -> q_pos, q_neg ([B,] nu_2, 2,
        2*t_gsw, 2, d)."""
        return self._neg_pair(regev_to_simple_gsw(gsw_src, self.pub.V,
                                                  self.params))

    def conv_direct(self, gsw_cts):
        """A direct query's GSW pairs ([B,] 2*nu_2*t_gsw, 2, 1, 2, d) ->
        q_pos, q_neg ([B,] nu_2, 2, 2*t_gsw, 2, d): the pair of digit j
        fills columns 2j (sr*val) and 2j+1 (val) (pack.py conv_direct)."""
        p = self.params
        pairs = gsw_cts[..., 0, :, :].unflatten(-4, (p.further_dims,
                                                     p.t_gsw, 2))
        # (.., nu_2, t_gsw, pair, row, 2, d) -> (.., nu_2, row, t_gsw, pair)
        q_pos = pairs.movedim(-3, -5).flatten(-4, -3)
        return self._neg_pair(q_pos)

    def _neg_pair(self, q_pos):
        # slot s selects bit nu_2-1-s (ref: testing.cpp:615-619)
        q_pos = q_pos.flip(-5)
        return q_pos, sub_raw(self._g_ntt.expand_as(q_pos), q_pos)

    def query_stages_batch(self, queries: list[Query], mark=no_mark):
        """The expansion and conversion stages of a batch of one form,
        `mark` called after each: the first-dimension scalars (B, dim0, 2,
        1, 2, d) and q_pos, q_neg (B, nu_2, 2, 2*t_gsw, 2, d).  A direct
        batch's reconstruction is its expansion stage, conv_direct its
        conversion."""
        return self._front(*stack_queries(queries, self.device), mark)

    def _front(self, seeds, bs: torch.Tensor, direct: bool, mark=no_mark):
        """query_stages_batch on the batch's seeds (or their seed_words)
        and b rows."""
        if direct:
            first_b, gsw_b = self.reconstruct_direct_batch(seeds, bs)
            mark()
            q_pos_b, q_neg_b = self.conv_direct(gsw_b)
        else:
            first_b, gsw_b = self.expand_batch(seeds, bs)
            mark()
            q_pos_b, q_neg_b = self.convert(gsw_b)
        mark()
        return first_b, q_pos_b, q_neg_b

    def first_dim_batch(self, first_b):
        """first_b (B, dim0, 2, 1, 2, d) -> (B, T, num_per, 2, 1, 2, d)
        coeff; an implicit slab's trial-major columns land in the same
        (T, num_per) order, and under a mesh the ranks' column blocks,
        gathered in rank order."""
        p = self.params
        res = multiply_query_by_db_batch(self._block, first_b[:, :, :, 0],
                                         self.num_chunks)
        if self.mesh is not None:
            res = shard.all_gather_tiled(res, self._group, dim=-1)
        d, T, B = p.poly_len, p.out_n ** 2, first_b.shape[0]
        cts = res.reshape(2, d, B, 2, T, p.num_per).permute(2, 4, 5, 3, 0, 1)
        return ntt.inverse(cts[:, :, :, :, None])

    def fold_batch(self, cts_b, q_pos_b, q_neg_b):
        """-> the (B, T, 2, 1, 2, d) survivors, coeff: one K5 launch per
        round."""
        return fold_pack_rounds_batch(cts_b, q_pos_b, q_neg_b,
                                      self.params)[:, :, 0]

    def fold(self, cts_coeff, q_pos, q_neg):
        """-> the (T, 2, 1, 2, d) survivors, coeff."""
        return fold_pack_rounds(cts_coeff, q_pos, q_neg, self.params)[:, 0]

    def pack(self, result):
        """([B,] T, 2, 1, 2, d) -> ([B,] out_n+1, out_n, 2, d) coeff: one
        K7 launch for the batch."""
        return ntt.inverse(pack_ciphertexts(result.contiguous(),
                                            self.pub.v_W))

    def _end(self, results, mark=no_mark):
        """Packing, then the modulus switch, `mark` called after each: the
        rows on the device."""
        packed = self.pack(results)
        mark()
        rows = modswitch_device(packed, self.params)
        mark()
        return rows

    def process_query_batch(self, queries: list[Query]):
        """Server.process_query_batch; over an implicit database it raises
        ValueError."""
        if isinstance(self.db, ImplicitDb):
            raise ValueError(
                "batched pack serving needs an encoded database, not an "
                "implicit one")
        return super().process_query_batch(queries)


def run_pack(params: Params, idx: int | None = None, seed: int = 0,
             nonoise: bool = False, rng: np.random.Generator | None = None,
             device="cuda"):
    """Self-checking end-to-end run: (correct, timings, client, server)."""
    rng = rng or np.random.default_rng(seed)
    idx = int(rng.integers(0, params.total_n)) if idx is None else idx
    client = PackClient(params, seed=seed, device=device, nonoise=nonoise)
    pub = client.setup()
    pts = random_pack_db(params, rng)
    server = PackServer(params, encode_pack_db(pts, params,
                                               torch.device(device)), pub)
    resp, timings = server.process_query(client.query(idx))
    correct = bool(np.array_equal(client.decode(resp),
                                  pts[idx].astype(object)))
    return correct, timings, client, server
