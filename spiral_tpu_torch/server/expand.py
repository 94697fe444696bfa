"""Automorphism-based coefficient expansion (counterpart of
spiral_tpu/server/expand.py).

Round r maps 2^r cts to 2^{r+1}: cv[num_in + i] = x^{-2^r} cv[i], then
cv[i] += KeySwitch_W(tau_t(cv[i])), t = d/2^r + 1, with W_left and m_exp
digits on even slots and W_right and m_exp_right on odd ones.  The key
switch is kernel K4 (csrc/expand.cu) on CUDA tensors, replacing the Pallas
key-switch (spiral_tpu/server/expand_pallas.py _keyswitch_call); on the
CPU it runs ``keyswitch_plain``.

tau_t(inverse NTT) is ``inv_ntt_automorph``, one launch of kernel K8a
(csrc/expand.cu) per round, replacing the Pallas kernel expand_pallas.py
_auto_call, which the JAX package runs under SPIRAL_AUTO=matmul; on the
CPU it runs ``inv_ntt_automorph_plain``: the inverse NTT, then the
coefficient-domain gather ``automorph_raw``.  K8a is K1's inverse on the
register NTT core (csrc/ntt_reg.cuh) with tau_t applied through shared
memory before the coalesced store, built for d in
``kernels.REG_NTT_DEGREES``.

The rounds' constants NTT(x^{-2^r}) are ``neg_monomial_ntts``, transformed
once per (d, device), as the JAX package builds them at trace time.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..params import Params
from .. import kernels
from ..arith import ntt
from ..core.gadget import gadget_invert_raw
from ..core.poly import add_raw, automorph_raw, matmul_raw, monomial, \
    scalar_mul_raw


@lru_cache(maxsize=None)
def _neg_monomials(d: int, device: str) -> tuple[torch.Tensor, ...]:
    monos = torch.cat([monomial(-1, d - (1 << r), d, device)
                       for r in range(d.bit_length())])
    return tuple(ntt.forward(monos)[:, 0].unbind(0))


def neg_monomial_ntts(d: int, device) -> tuple[torch.Tensor, ...]:
    """NTT(x^{-2^r}) = NTT(-x^{d - 2^r}) (2, d) for r = 0 .. log2(d): the
    JAX ``_neg_monomial_ntt`` of every round, made by one forward NTT (one
    K1 launch on the card) at the first call per (d, device) and the same
    tensors after it."""
    return _neg_monomials(d, str(torch.device(device)))


def inv_ntt_automorph_plain(x: torch.Tensor, t: int) -> torch.Tensor:
    """x (..., 2, d) NTT -> tau_t(inverse(x)) (..., 2, d) coeff."""
    return automorph_raw(ntt.inverse_plain(x), t)


def inv_ntt_automorph(x: torch.Tensor, t: int) -> torch.Tensor:
    """inv_ntt_automorph_plain, as one launch of K8a on a CUDA tensor (the
    JAX expand_pallas.py inv_ntt_automorph under SPIRAL_AUTO=matmul)."""
    if kernels.on_cpu(x):
        return inv_ntt_automorph_plain(x, t)
    x = x.contiguous()
    d = x.shape[-1]
    kernels.require(x, x.shape, "auto input")
    if x.shape[-2] != 2 or d not in kernels.REG_NTT_DEGREES or t % 2 == 0:
        raise ValueError(f"auto kernel takes (..., 2, d), d in "
                         f"{kernels.REG_NTT_DEGREES}, and an odd t; got "
                         f"{tuple(x.shape)}, t {t}")
    out = torch.empty_like(x)
    n_polys = x.numel() // d
    if n_polys:
        kernels.check(kernels.lib().spiral_inv_ntt_automorph(
            x.data_ptr(), out.data_ptr(),
            ntt.kernel_table(d, x.device).data_ptr(), n_polys, d, t,
            kernels.stream()), "spiral_inv_ntt_automorph")
        kernels.LAUNCHES["auto"] += 1
    return out


def keyswitch_plain(cv: torch.Tensor, c_auto: torch.Tensor, W: torch.Tensor,
                    m: int) -> torch.Tensor:
    """cv (N, 2, 1, 2, d) NTT, c_auto = tau(inverse(cv)) (N, 2, 1, 2, d)
    coeff, W (2, m, 2, d) NTT -> cv + W @ NTT(G^{-1}(c_auto row 0)), with
    NTT(c_auto row 1) added to the bottom row."""
    ginv = ntt.forward_plain(gadget_invert_raw(c_auto[:, 0:1], m, 1))
    out = add_raw(cv, matmul_raw(W, ginv))
    bottom = add_raw(out[:, 1:2], ntt.forward_plain(c_auto[:, 1:2]))
    return torch.cat([out[:, :1], bottom], dim=1)


def keyswitch(cv: torch.Tensor, c_auto: torch.Tensor, W: torch.Tensor,
              m: int) -> torch.Tensor:
    if kernels.on_cpu(cv, c_auto, W):
        return keyswitch_plain(cv, c_auto, W, m)
    N, d = cv.shape[0], cv.shape[-1]
    for t, name in ((cv, "expand cv"), (c_auto, "expand c_auto")):
        kernels.require(t, (N, 2, 1, 2, d), name)
    kernels.require(W, (2, m, 2, d), "expand W")
    if d not in kernels.REG_NTT_DEGREES:
        raise ValueError(f"expand kernel takes d in "
                         f"{kernels.REG_NTT_DEGREES}, got {d}")
    out = torch.empty_like(cv)
    if N:
        kernels.check(kernels.lib().spiral_expand_keyswitch(
            cv.data_ptr(), c_auto.data_ptr(), W.data_ptr(), out.data_ptr(),
            ntt.kernel_table(d, cv.device).data_ptr(), N, m, d,
            kernels.stream()), "spiral_expand_keyswitch")
        kernels.LAUNCHES["expand"] += 1
    return out


def coefficient_expansion(cv0: torch.Tensor, g: int, W_left: list,
                          W_right: list, params: Params,
                          max_bits_to_gen_right: int = 0,
                          stopround: int = 0) -> torch.Tensor:
    """Expand one ct (2, 1, 2, d) NTT into 2^g cts (2^g, 2, 1, 2, d), or a
    batch (B, 2, 1, 2, d) into (B, 2^g, 2, 1, 2, d).  With stopround > 0,
    odd slots stop after round `stopround`, where only odd slot i <=
    max_bits_to_gen_right is updated (expand.py:131-167).  The batch shares
    the keys W, so each round makes one K8a launch and one K4 launch per
    side for all B queries (what jax.vmap of the JAX expansion computes)."""
    single = cv0.dim() == 4
    d = params.poly_len
    cv = cv0[:, None] if not single else cv0[None, None]   # (B, 1, ...)
    B = cv.shape[0]

    def ks(c, c_auto, W, m):      # (B, n, 2, 1, 2, d) for all B at once
        n = c.shape[1]
        out = keyswitch(c.reshape(B * n, 2, 1, 2, d).contiguous(),
                        c_auto.reshape(B * n, 2, 1, 2, d).contiguous(), W, m)
        return out.reshape(B, n, 2, 1, 2, d)

    neg = neg_monomial_ntts(d, cv.device)
    for r in range(g):
        t = (d >> r) + 1
        cv = torch.cat([cv, scalar_mul_raw(neg[r], cv)], dim=1)
        evens, odds = cv[:, 0::2].contiguous(), cv[:, 1::2].contiguous()
        odd_live = stopround == 0 or r <= stopround
        todo = cv if odd_live else evens
        c_auto = inv_ntt_automorph(todo, t)
        if odd_live:
            c_even, c_odd = c_auto[:, 0::2], c_auto[:, 1::2]
        else:
            c_even = c_auto
        new_evens = ks(evens, c_even, W_left[r], params.m_exp)
        if not odd_live:
            new_odds = odds
        else:
            keep = odds.shape[1]
            if stopround > 0 and r == stopround:
                keep = min(keep, max_bits_to_gen_right + 1)
            new_odds = torch.cat([
                ks(odds[:, :keep], c_odd[:, :keep], W_right[r],
                   params.m_exp_right), odds[:, keep:]], dim=1)
        cv = torch.stack([new_evens, new_odds], dim=2).reshape(
            (B, cv.shape[1]) + cv.shape[2:])
    return cv[0] if single else cv


def reorder_from_stopround(cv, even_count: int, odd_count: int):
    """Evens first, then odds, along the ct axis (-5) of ([B,] n, 2, 1, 2,
    d)."""
    even, odd = cv.unflatten(-5, (-1, 2)).unbind(-5)
    return torch.cat([even[..., :even_count, :, :, :, :],
                      odd[..., :odd_count, :, :, :, :]], dim=-5)
