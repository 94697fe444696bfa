"""Seed-compressed queries (counterpart of spiral_tpu/crypto/query.py).
The query carries a 32-bit seed and the b halves of its scalar cts; both
sides rebuild each a from the seed with JAX's threefry stream, so a query
from either package's client is answered by either server.

Spiral uploads one packed ct whose coefficients hold the first-dimension
indicator and the GSW digit values, pre-scaled by 2^-g.  SpiralStream
(Params.expansion_plan() not None) uploads each part of the query either
directly, one ct per value, or as subround cts that the server expands
(``subround_sigma_polys``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..params import Params, Q, get_bits_per
from ..arith import ntt
from ..arith.crt import residues_from_values
from ..core.poly import add_raw, neg_raw, scalar_mul_raw
from ..core.sampling import uniform_key_words, uniform_residues_words
from ..core.threefry import key_from_seed
from .encrypt import Encryptor


@dataclasses.dataclass
class Query:
    """The packed form sets packed_b; the direct form first_b (the first
    part's b rows) and gsw_b (the rest part's).  Each is (n, 1, 1, 2, d)
    int32, NTT."""
    seed: int
    packed_b: torch.Tensor | None = None
    first_b: torch.Tensor | None = None
    gsw_b: torch.Tensor | None = None
    size_bytes: int = 0


def seed_words(seeds, device) -> torch.Tensor:
    """The key words the seeds' a halves are drawn from (jax.random.key(seed)
    -> sampling.uniform_key_words), on `device`: the one copy to the card
    that rebuilding a batch's cts makes.  Staged before a CUDA graph
    capture, they stand for the seeds in derive_a_ntt_batch and
    reconstruct_cts."""
    return uniform_key_words([key_from_seed(int(s)) for s in seeds], device)


def derive_a_ntt_batch(seeds, n_cts: int, d: int, device) -> torch.Tensor:
    """The PRF-derived uniform a halves of each seed's query, NTT domain
    (B, n_cts, 1, 1, 2, d): jax.random.key(seed) -> uniform_residues ->
    NTT, bit for bit, all seeds in one pass.  `seeds`: a list of B seeds,
    or their seed_words."""
    words = seeds if torch.is_tensor(seeds) else seed_words(seeds, device)
    return ntt.forward(uniform_residues_words(words, (n_cts, 1, 1, d)))


def derive_a_ntt(seed: int, n_cts: int, d: int, device) -> torch.Tensor:
    """One seed's a halves (n_cts, 1, 1, 2, d)."""
    return derive_a_ntt_batch([seed], n_cts, d, device)[0]


def reconstruct_cts(seed, b_ntt: torch.Tensor) -> torch.Tensor:
    """(-a, b) scalar cts from the seed and b rows: (n, 1, 1, 2, d) ->
    (n, 2, 1, 2, d).  For a list of B seeds (or their seed_words), one
    query each: (B, n, 1, 1, 2, d) -> (B, n, 2, 1, 2, d)."""
    single = isinstance(seed, (int, np.integer))
    b = b_ntt[None] if single else b_ntt
    a = derive_a_ntt_batch([seed] if single else seed, b.shape[1],
                           b.shape[-1], b.device)
    out = torch.cat([neg_raw(a), b], dim=-4)
    return out[0] if single else out


def query_b_rows(q: Query) -> torch.Tensor:
    """The b rows a server rebuilds its cts from: packed_b, or first_b
    followed by gsw_b."""
    if q.packed_b is not None:
        return q.packed_b
    return torch.cat([q.first_b, q.gsw_b])


def encrypt_b_batch(enc: Encryptor, seed: int, sigmas_ntt: torch.Tensor
                    ) -> torch.Tensor:
    """b = a*sr + e + sigma for sigmas (n, 1, 1, 2, d) NTT, the a halves
    drawn from `seed`."""
    n, d = sigmas_ntt.shape[0], sigmas_ntt.shape[-1]
    asr = scalar_mul_raw(ntt.forward(enc.keys.sr)[0, 0],
                         derive_a_ntt(seed, n, d, enc.device))
    e_ntt = ntt.forward(enc.noise(n, 1)[:, None])
    return add_raw(add_raw(asr, e_ntt), sigmas_ntt)


def sigmas_ntt(sigs: np.ndarray, device) -> torch.Tensor:
    """(n, d) python ints -> their NTTs (n, 1, 1, 2, d)."""
    v = torch.tensor(np.asarray(sigs, dtype=object).astype(np.int64))
    return ntt.forward(residues_from_values(v)[:, None, None].to(device))


def new_seed(enc: Encryptor) -> int:
    return int(torch.randint(0, np.iinfo(np.int32).max, (),
                             generator=enc.gen))


def gsw_digit_values(params: Params, idx: int) -> list[int]:
    """The GSW sources' plaintexts, nu_2 * t_gsw of them: bit i of idx's
    further index times 2^(bits_per*j) for digit j."""
    idx_further = idx % params.num_per
    bits_per = get_bits_per(params.t_gsw)
    return [((idx_further >> i) & 1) << (bits_per * j)
            for i in range(params.further_dims)
            for j in range(params.t_gsw)]


def sigma_poly(params: Params, idx: int, g: int, stop: int) -> np.ndarray:
    """The packed query's plaintext (query.py:69-96) for an expansion of g
    rounds whose odd slots stop after round `stop` (0: no stop): (d,)
    python ints."""
    idx_dim0 = idx // params.num_per
    vals = gsw_digit_values(params, idx)
    sig = np.zeros(params.poly_len, dtype=object)
    if stop != 0:
        sig[2 * idx_dim0] = params.scale_k
        sig[1:2 * len(vals):2] = vals
        sig[0::2] = (sig[0::2] * pow(1 << g, -1, Q)) % Q
        sig[1::2] = (sig[1::2] * pow(1 << (stop + 1), -1, Q)) % Q
    else:
        sig[idx_dim0] = params.scale_k
        sig[params.dim0:params.dim0 + len(vals)] = vals
        sig = (sig * pow(1 << g, -1, Q)) % Q
    return sig


def subround_sigma_polys(params: Params, idx: int) -> np.ndarray:
    """The plaintexts of the direct / subround upload (query.py:124-170;
    ref: src/spiral.cpp:2116-2155): the first part's cts, then the rest
    part's, (n_first_cts + n_rest_cts, d) python ints.  A direct part puts
    one value in coefficient 0 of each ct; an expanded part packs `bits`
    values per ct into its low coefficients, pre-scaled by 2^-g."""
    plan = params.expansion_plan()
    d = params.poly_len
    idx_dim0 = idx // params.num_per
    out = []
    pf = plan["first"]
    if pf["direct"]:
        for j in range(params.dim0):
            s = np.zeros(d, dtype=object)
            if j == idx_dim0:
                s[0] = params.scale_k
            out.append(s)
    else:
        inv = pow(1 << pf["g"], -1, Q)
        for srd in range(pf["n_cts"]):
            s = np.zeros(d, dtype=object)
            if idx_dim0 // pf["bits"] == srd:
                s[idx_dim0 % pf["bits"]] = (params.scale_k * inv) % Q
            out.append(s)
    pr = plan["rest"]
    vals = gsw_digit_values(params, idx)
    if pr["direct"]:
        for v in vals:
            s = np.zeros(d, dtype=object)
            s[0] = v
            out.append(s)
    else:
        inv = pow(1 << pr["g"], -1, Q)
        for srd in range(pr["n_cts"]):
            s = np.zeros(d, dtype=object)
            for ctr, v in enumerate(
                    vals[srd * pr["bits"]:(srd + 1) * pr["bits"]]):
                s[ctr] = (v * inv) % Q
            out.append(s)
    return np.stack(out)


def packed_query(params: Params, enc: Encryptor, idx: int, g: int,
                 stop: int) -> Query:
    """One packed ct for record idx, for an expansion of g rounds whose odd
    slots stop after round `stop`: (params.g, params.stopround) for
    Spiral, pack_g_stop for the pack variant."""
    seed = new_seed(enc)
    sig = sigmas_ntt(sigma_poly(params, idx, g, stop)[None], enc.device)
    return Query(seed=seed, packed_b=encrypt_b_batch(enc, seed, sig),
                 size_bytes=params.bytes_per_poly)


def generate_query(params: Params, enc: Encryptor, idx: int) -> Query:
    """The Spiral client's query for record idx: the packed ct, or, where
    the parameters give an expansion plan, one b per uploaded ct
    (subround_sigma_polys), all from one seed."""
    plan = params.expansion_plan()
    if plan is None:
        return packed_query(params, enc, idx, params.g, params.stopround)
    seed = new_seed(enc)
    sigs = subround_sigma_polys(params, idx)
    b = encrypt_b_batch(enc, seed, sigmas_ntt(sigs, enc.device))
    n_first = plan["first"]["n_cts"]
    return Query(seed=seed, first_b=b[:n_first], gsw_b=b[n_first:],
                 size_bytes=len(sigs) * params.bytes_per_poly)
