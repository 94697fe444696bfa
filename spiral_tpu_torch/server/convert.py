"""Ciphertext composition and conversion (counterpart of
spiral_tpu/server/convert.py): NTTs (K1) around plain modular matmuls; the
JAX package has no Pallas kernel for this stage."""
from __future__ import annotations

import torch

from ..params import Params
from ..arith import ntt
from ..core.gadget import gadget_invert_raw
from ..core.poly import add_raw, matmul_raw


def _special_distribute(ginv_ntt: torch.Tensor) -> torch.Tensor:
    """(N, m_conv, 1, 2, d) -> (N, 2*m_conv, 2, 2, d) block-diagonal copy."""
    N, m_conv, _, _, d = ginv_ntt.shape
    z = torch.zeros_like(ginv_ntt)
    col0 = torch.cat([ginv_ntt, z], dim=2)
    col1 = torch.cat([z, ginv_ntt], dim=2)
    return torch.stack([col0, col1], dim=2).reshape(N, 2 * m_conv, 2, 2, d)


def scal_to_mat_batch(cv: torch.Tensor, W: torch.Tensor, params: Params,
                      ginv_ntt: torch.Tensor | None = None) -> torch.Tensor:
    """cv (..., N, n0, 1, 2, d) NTT scalar cts, W (n1, n0*m_conv, 2, d) ->
    (..., N, n1, n0, 2, d) matrix cts; a leading query axis is what
    jax.vmap of the JAX function computes."""
    lead = cv.shape[:-5]
    cv = cv.reshape((-1,) + cv.shape[-4:])
    if ginv_ntt is None:
        c_coeff = ntt.inverse(cv)
        ginv_ntt = ntt.forward(gadget_invert_raw(c_coeff[:, 0:1],
                                                 params.m_conv, 1))
    prod = matmul_raw(W, _special_distribute(ginv_ntt))
    c1 = cv[:, 1, 0]                                  # (N, 2, d)
    pad = torch.zeros_like(prod)
    pad[:, 1, 0] = c1
    pad[:, 2, 1] = c1
    out = add_raw(prod, pad)
    return out.reshape(lead + (-1,) + out.shape[1:])


def regev_to_gsw_batch(cv: torch.Tensor, W: torch.Tensor, V: torch.Tensor,
                       params: Params) -> torch.Tensor:
    """cv (..., nu_2, t_gsw, n0, 1, 2, d) NTT scalar cts -> (..., nu_2, n1,
    m2, 2, d) GSW cts, columns in the reference's permuted order
    (convert.py:78-85); a leading query axis as jax.vmap gives it."""
    lead = cv.shape[:-6]
    cv = cv.reshape((-1,) + cv.shape[-5:])
    nu2, t = cv.shape[:2]
    m_conv, n1, n0, d = params.m_conv, params.n1, params.n0, params.poly_len
    flat = cv.reshape((nu2 * t,) + cv.shape[2:])
    c_coeff = ntt.inverse(flat)
    ginv0 = ntt.forward(gadget_invert_raw(c_coeff[:, 0:1], m_conv, 1))
    ginv1 = ntt.forward(gadget_invert_raw(c_coeff[:, 1:2], m_conv, 1))
    stm = scal_to_mat_batch(flat, W, params, ginv_ntt=ginv0)
    stm = stm.reshape(nu2, t, n1, n0, 2, d)
    g0 = ginv0.reshape(nu2, t, m_conv, 2, d)
    g1 = ginv1.reshape(nu2, t, m_conv, 2, d)
    chat = torch.cat([g0, g1], dim=2).transpose(1, 2)   # (nu2, 2m_conv, t, ..)
    prod = matmul_raw(V, chat)                          # (nu2, n1, t, 2, d)
    blocks = torch.cat([prod.transpose(1, 2)[:, :, :, None], stm], dim=3)
    out = blocks.permute(0, 2, 1, 3, 4, 5).reshape(nu2, n1, t * (n0 + 1),
                                                   2, d)
    return out.reshape(lead + (-1,) + out.shape[-4:])
