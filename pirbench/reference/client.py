"""The plain Spiral client: secret keys, public parameters, queries for a
list of record indices, and the decode of responses to records.

Frozen copy, at commit 1095982, of spiral_tpu_torch/crypto/keys.py,
crypto/encrypt.py, crypto/publicparams.py (generate_public_params),
crypto/query.py (gsw_digit_values, sigma_poly, encrypt_b_batch: the
packed query) and crypto/decode.py (decode_response).  Two changes of
form, not of result: queries for many indices are made in one pass (their
seeds drawn first, then their noise), with each plaintext's few nonzero
values scattered into residues; and decode runs for many responses at
once, the negacyclic product with the small key as an exact float64
matrix product (every partial sum is an integer below 2^53).

All randomness comes from one torch.Generator on the CPU seeded with the
client's seed, so a seed gives the same keys, public parameters and
queries on any device; the arithmetic runs on `device`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import prng, ring
from .ring import (add_raw, matmul_raw, neg_raw, ntt_forward, ntt_inverse,
                   residues_from_values, scalar_mul_raw)
from .scheme import Q, SchemeParams, get_bits_per


@dataclasses.dataclass
class PlainQuery:
    """One packed query: its seed and its b row (1, 1, 1, 2, d) int32,
    NTT."""
    seed: int
    packed_b: torch.Tensor


class PlainClient:
    """The Spiral client of the packed one-ciphertext query (the form of
    every configuration with query_elems_rest 0)."""

    def __init__(self, params: SchemeParams, seed: int, device="cpu"):
        if params.query_elems_rest != 0:
            raise ValueError("the plain client makes packed queries only "
                             "(query_elems_rest 0)")
        self.params = params
        self.device = torch.device(device)
        self.gen = torch.Generator().manual_seed(int(seed))
        d = params.poly_len
        self.Sp_centered = self._small((params.n0, params.k_param, d))
        self.sr_centered = self._small((1, 1, d))
        self.Sp = residues_from_values(self.Sp_centered).to(self.device)
        self.sr = residues_from_values(self.sr_centered).to(self.device)
        self.sr_ntt = ntt_forward(self.sr)[0, 0]

    def _small(self, shape) -> torch.Tensor:
        return (prng.ternary_values if self.params.ternary
                else prng.gaussian_values)(self.gen, shape)

    # -- encryption (crypto/encrypt.py) --
    def _noise(self, shape) -> torch.Tensor:
        """Gaussian error (*shape, 2, d) residues, coefficient domain."""
        v = prng.gaussian_values(self.gen, tuple(shape) +
                                 (self.params.poly_len,))
        return residues_from_values(v).to(self.device)

    def _uniform(self, rows: int, cols: int) -> torch.Tensor:
        return prng.uniform_residues(
            self.gen, (rows, cols, self.params.poly_len)).to(self.device)

    def _encrypt_matrix(self, M_ntt: torch.Tensor) -> torch.Tensor:
        """[-A; Sp*A + E] + [0; M], NTT domain."""
        m = M_ntt.shape[1]
        A = self._uniform(self.Sp.shape[1], m)
        B = add_raw(matmul_raw(ntt_forward(self.Sp), ntt_forward(A)),
                    ntt_forward(self._noise((self.Sp.shape[0], m))))
        P = ntt_forward(torch.cat([neg_raw(A), ntt_inverse(B)], dim=0))
        k = self.Sp.shape[1]
        return torch.cat([P[:k], add_raw(P[k:], M_ntt)], dim=0)

    def _encrypt_regev_row(self, M_ntt: torch.Tensor) -> torch.Tensor:
        m = M_ntt.shape[1]
        a = self._uniform(1, m)
        b = add_raw(scalar_mul_raw(self.sr_ntt, ntt_forward(a)),
                    ntt_forward(self._noise((1, m))))
        return torch.cat([ntt_forward(neg_raw(a)), add_raw(b, M_ntt)], dim=0)

    # -- public parameters (crypto/publicparams.py) --
    def _expansion_keys(self, rounds: int, m_exp: int) -> list:
        d = self.params.poly_len
        G_exp = ntt_forward(ring.build_gadget(1, m_exp, d, self.device))
        return [self._encrypt_regev_row(scalar_mul_raw(
            ntt_forward(ring.automorph_raw(self.sr, (d >> r) + 1))[0, 0],
            G_exp)) for r in range(rounds)]

    def public_params(self) -> dict:
        """{W_exp_left, W_exp_right: lists of key matrices, W_conv, V}."""
        p, d = self.params, self.params.poly_len
        right = p.stopround + 1 if p.stopround > 0 else p.g
        W_left = self._expansion_keys(p.g, p.t_exp)
        W_right = self._expansion_keys(right, p.t_exp_right)
        G_scale = ntt_forward(ring.build_gadget(p.n0, p.n0 * p.t_conv, d,
                                                self.device))
        W_conv = self._encrypt_matrix(scalar_mul_raw(self.sr_ntt, G_scale))
        gv = ntt_forward(ring.build_gadget(1, p.t_conv, d, self.device))
        together = torch.cat([scalar_mul_raw(self.sr_ntt, gv), gv], dim=1)
        V = self._encrypt_matrix(matmul_raw(ntt_forward(self.Sp), together))
        return {"W_exp_left": W_left, "W_exp_right": W_right,
                "W_conv": W_conv, "V": V}

    # -- queries (crypto/query.py) --
    def _gsw_digit_values(self, idx: int) -> list[int]:
        p = self.params
        idx_further = idx % p.num_per
        bits_per = get_bits_per(p.t_gsw)
        return [((idx_further >> i) & 1) << (bits_per * j)
                for i in range(p.nu_2) for j in range(p.t_gsw)]

    def _sigma_terms(self, idx: int) -> list[tuple[int, int]]:
        """sigma_poly's plaintext for record idx as its nonzero (position,
        value mod Q) terms: the first-dimension indicator and the GSW
        digit values, pre-scaled for an expansion of g rounds whose odd
        slots stop after round `stopround` (0: no stop)."""
        p = self.params
        idx_dim0 = idx // p.num_per
        vals = self._gsw_digit_values(idx)
        g, stop = p.g, p.stopround
        if stop != 0:
            inv_e, inv_o = pow(1 << g, -1, Q), pow(1 << (stop + 1), -1, Q)
            return [(2 * idx_dim0, p.scale_k * inv_e % Q)] + \
                [(1 + 2 * i, v * inv_o % Q) for i, v in enumerate(vals)]
        inv = pow(1 << g, -1, Q)
        return [(idx_dim0, p.scale_k * inv % Q)] + \
            [(p.dim0 + i, v * inv % Q) for i, v in enumerate(vals)]

    def queries(self, idxs) -> list[PlainQuery]:
        """One query for each record index, made in one pass: b = a*sr + e
        + sigma (NTT domain), a drawn from the query's seed by the threefry
        stream the server replays.  The b rows come back on the host."""
        d = self.params.poly_len
        idxs = [int(i) for i in idxs]
        N = len(idxs)
        seeds = torch.randint(0, np.iinfo(np.int32).max, (N,),
                              generator=self.gen).tolist()
        sig = np.zeros((N, 2, d), dtype=np.int64)
        for q, idx in enumerate(idxs):
            for pos, v in self._sigma_terms(idx):
                sig[q, 0, pos] = v % ring.P_I
                sig[q, 1, pos] = v % ring.B_I
        sig_ntt = ntt_forward(torch.from_numpy(sig).to(torch.int32)
                              .to(self.device))[:, None, None, None]
        e_ntt = ntt_forward(self._noise((N, 1, 1, 1)))
        a_ntt = ntt_forward(prng.seed_uniform_residues(
            seeds, (1, 1, 1, d), self.device))
        b = add_raw(add_raw(scalar_mul_raw(self.sr_ntt, a_ntt), e_ntt),
                    sig_ntt).cpu()
        return [PlainQuery(seed=s, packed_b=b[q])
                for q, s in enumerate(seeds)]

    # -- decode (crypto/decode.py) --
    def decode(self, first_rows: np.ndarray, rest_rows: np.ndarray,
               device="cpu") -> np.ndarray:
        """Responses (R, 1, cols, d) mod q' and (R, n0, cols, d) mod 4p ->
        their plaintexts (R, n0, cols, d) mod p, int64."""
        p = self.params
        qp, q1, pt = p.arb_qprime, 4 * p.p_db, p.p_db
        d = p.poly_len
        first = torch.from_numpy(np.asarray(first_rows, dtype=np.int64))
        rest = np.asarray(rest_rows, dtype=np.int64)
        b = first[:, 0].reshape(-1, d).to(device, torch.float64)
        k = torch.arange(d)
        diff = k[:, None] - k[None, :]                      # k - j
        out = np.empty(rest.shape, dtype=np.int64)
        denom = qp * (q1 // pt)
        for r in range(p.n0):
            a = self.Sp_centered[r, 0].to(torch.float64)
            # negacyclic product c = a * b as b @ M^T, M[k, j] = a[k - j]
            # for k >= j, else -a[k - j + d]
            M = torch.where(diff >= 0, a[diff % d], -a[diff % d])
            sp = (b @ M.to(device).T).round().to(torch.int64).cpu()
            sp = torch.remainder(sp, qp).numpy().reshape(first.shape[0], -1, d)
            val_first = np.where(sp >= qp // 2, sp - qp, sp)
            vr = rest[:, r]
            val_rest = np.where(vr >= q1 // 2, vr - q1, vr)
            rr = val_first * q1 + val_rest * qp
            sign = np.where(rr >= 0, 1, -1)
            num = rr + sign * (denom // 2)
            res = num // denom + np.where((num % denom != 0) & (sign < 0),
                                          1, 0)
            out[:, r] = res % pt
        return out
