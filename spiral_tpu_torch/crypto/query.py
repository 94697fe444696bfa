"""Seed-compressed queries (counterpart of spiral_tpu/crypto/query.py),
packed one-ciphertext form.  The query carries a 32-bit seed and the b
half; both sides rebuild a from the seed with JAX's threefry stream, so a
query from either package's client is answered by either server."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..params import Params, Q, get_bits_per
from ..arith import ntt
from ..arith.crt import residues_from_values
from ..core.poly import add_raw, neg_raw, scalar_mul_raw
from ..core.sampling import uniform_residues_jax
from ..core.threefry import key_from_seed
from .encrypt import Encryptor


@dataclasses.dataclass
class Query:
    seed: int
    packed_b: torch.Tensor    # (1, 1, 1, 2, d) int32, NTT
    size_bytes: int = 0


def derive_a_ntt_batch(seeds, n_cts: int, d: int, device) -> torch.Tensor:
    """The PRF-derived uniform a halves of each seed's query, NTT domain
    (B, n_cts, 1, 1, 2, d): jax.random.key(seed) -> uniform_residues ->
    NTT, bit for bit, all seeds in one pass."""
    keys = [key_from_seed(int(s)) for s in seeds]
    return ntt.forward(uniform_residues_jax(keys, (n_cts, 1, 1, d), device))


def derive_a_ntt(seed: int, n_cts: int, d: int, device) -> torch.Tensor:
    """One seed's a halves (n_cts, 1, 1, 2, d)."""
    return derive_a_ntt_batch([seed], n_cts, d, device)[0]


def reconstruct_cts(seed, b_ntt: torch.Tensor) -> torch.Tensor:
    """(-a, b) scalar cts from the seed and b rows: (n, 1, 1, 2, d) ->
    (n, 2, 1, 2, d).  For a list of B seeds, one query each:
    (B, n, 1, 1, 2, d) -> (B, n, 2, 1, 2, d)."""
    single = isinstance(seed, (int, np.integer))
    b = b_ntt[None] if single else b_ntt
    a = derive_a_ntt_batch([seed] if single else seed, b.shape[1],
                           b.shape[-1], b.device)
    out = torch.cat([neg_raw(a), b], dim=-4)
    return out[0] if single else out


def sigma_poly(params: Params, idx: int, g: int, stop: int) -> np.ndarray:
    """The packed query's plaintext (query.py:69-96) for an expansion of g
    rounds whose odd slots stop after round `stop` (0: no stop): (d,)
    python ints."""
    d = params.poly_len
    idx_dim0, idx_further = divmod(idx, params.num_per)
    ell = params.t_gsw
    bits_per = get_bits_per(ell)
    sig = np.zeros(d, dtype=object)
    if stop != 0:
        sig[2 * idx_dim0] = params.scale_k
        for i in range(params.further_dims):
            bit = (idx_further >> i) & 1
            for j in range(ell):
                sig[2 * (i * ell + j) + 1] = bit << (bits_per * j)
        sig[0::2] = (sig[0::2] * pow(1 << g, -1, Q)) % Q
        sig[1::2] = (sig[1::2] * pow(1 << (stop + 1), -1, Q)) % Q
    else:
        sig[idx_dim0] = params.scale_k
        for i in range(params.further_dims):
            bit = (idx_further >> i) & 1
            for j in range(ell):
                sig[params.dim0 + i * ell + j] = bit << (bits_per * j)
        sig = (sig * pow(1 << g, -1, Q)) % Q
    return sig


def generate_query(params: Params, enc: Encryptor, idx: int,
                   g_stop: tuple[int, int] | None = None) -> Query:
    """One packed ct for record idx.  g_stop is the expansion's (g, stop):
    (params.g, params.stopround) for Spiral, pack_g_stop for the pack
    variant."""
    if params.expansion_plan() is not None:
        raise NotImplementedError("only the packed one-ct query form")
    d, dev = params.poly_len, enc.device
    g, stop = g_stop or (params.g, params.stopround)
    seed = int(torch.randint(0, np.iinfo(np.int32).max, (),
                             generator=enc.gen))
    sig = torch.tensor(sigma_poly(params, idx, g, stop).astype(np.int64))
    sig_ntt = ntt.forward(residues_from_values(sig)[None, None, None]
                          .to(dev))
    a_ntt = derive_a_ntt(seed, 1, d, dev)
    asr = scalar_mul_raw(ntt.forward(enc.keys.sr)[0, 0], a_ntt)
    e_ntt = ntt.forward(enc.noise(1, 1)[None])
    b = add_raw(add_raw(asr, e_ntt), sig_ntt)
    return Query(seed=seed, packed_b=b, size_bytes=params.bytes_per_poly)
