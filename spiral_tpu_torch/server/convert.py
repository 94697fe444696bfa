"""Ciphertext composition and conversion (counterpart of
spiral_tpu/server/convert.py).

``compose_cts`` and ``convert_cts`` are the served stage: on CUDA tensors
one launch each of kernel K9 (csrc/convert.cu: the inverse NTT, the
digits, their NTTs and every product in registers), on CPU tensors the
plain versions ``scal_to_mat_batch`` and ``regev_to_gsw_batch``: NTTs
around broadcast int64 modular matmuls, as the JAX package runs this
stage (it has no Pallas kernel for it).  K9 takes the presets' m_conv 4,
n0 2, n1 3 and d in ``kernels.REG_NTT_DEGREES``, any number of cts and a
leading query axis; it raises on anything else.
"""
from __future__ import annotations

import torch

from ..params import Params
from .. import kernels
from ..arith import ntt
from ..core.gadget import gadget_invert_raw
from ..core.poly import add_raw, matmul_raw, sub_raw


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


def convert_plain(cv: torch.Tensor, W: torch.Tensor, V: torch.Tensor,
                  g2: torch.Tensor, params: Params):
    """cv ([B,] nu_2*t_gsw, 2, 1, 2, d) NTT scalar cts, g2 the gadget
    (n1, m2, 2, d) NTT -> q_pos, q_neg ([B,] nu_2, n1, m2, 2, d): the GSW
    cts of regev_to_gsw_batch in reverse order, and G2 - q_pos."""
    gsw = regev_to_gsw_batch(
        cv.unflatten(-5, (params.further_dims, params.t_gsw)), W, V, params)
    q_pos = gsw.flip(-5)
    return q_pos, sub_raw(g2.expand_as(q_pos), q_pos)


def _k9_operand(cv: torch.Tensor, d: int, name: str):
    """cv (..., N, 2, 1, 2, d) -> (cv as contiguous (B, N, 2, 1, 2, d), B,
    N)."""
    if cv.dim() < 5 or tuple(cv.shape[-4:]) != (2, 1, 2, d):
        raise ValueError(f"{name}: want (..., N, 2, 1, 2, {d}) scalar cts, "
                         f"got {tuple(cv.shape)}")
    cv = cv.reshape((-1,) + cv.shape[-5:]).contiguous()
    kernels.require(cv, cv.shape, name)
    return cv, cv.shape[0], cv.shape[1]


def k9_takes(params: Params, d: int) -> None:
    """Raise ValueError unless kernel K9 takes these parameters: m_conv 4,
    n0 2, n1 3 and d in kernels.REG_NTT_DEGREES (every SpiralServer
    preset).  A CUDA SpiralServer checks this when it is made."""
    if (params.m_conv, params.n0, params.n1) != (4, 2, 3) or \
            d not in kernels.REG_NTT_DEGREES:
        raise ValueError(f"kernel K9 takes m_conv 4, n0 2, n1 3 and d in "
                         f"{kernels.REG_NTT_DEGREES}; got m_conv "
                         f"{params.m_conv}, n0 {params.n0}, n1 {params.n1}, "
                         f"d {d}")


def compose_cts(cv: torch.Tensor, W: torch.Tensor,
                params: Params) -> torch.Tensor:
    """scal_to_mat_batch: cv ([B,] N, n0, 1, 2, d) -> ([B,] N, n1, n0, 2,
    d); one launch of K9 on CUDA tensors."""
    if kernels.on_cpu(cv, W):
        return scal_to_mat_batch(cv, W, params)
    d = cv.shape[-1]
    k9_takes(params, d)
    kernels.require(W, (3, 8, 2, d), "K9 W")
    lead = cv.shape[:-5]
    x, B, N = _k9_operand(cv, d, "K9 compose cts")
    out = torch.empty((B, N, 3, 2, 2, d), dtype=torch.int32,
                      device=cv.device)
    if B * N:
        kernels.check(kernels.lib().spiral_compose(
            x.data_ptr(), B * N, W.data_ptr(), out.data_ptr(),
            ntt.kernel_table(d, cv.device).data_ptr(), d, kernels.stream()),
            "spiral_compose")
        kernels.LAUNCHES["compose"] += 1
    return out.reshape(lead + out.shape[1:])


def convert_cts(cv: torch.Tensor, W: torch.Tensor, V: torch.Tensor,
                g2: torch.Tensor, params: Params):
    """convert_plain: cv ([B,] nu_2*t_gsw, 2, 1, 2, d) -> q_pos, q_neg
    ([B,] nu_2, n1, m2, 2, d); one launch of K9 on CUDA tensors."""
    if kernels.on_cpu(cv, W, V, g2):
        return convert_plain(cv, W, V, g2, params)
    d, nu2, t = cv.shape[-1], params.further_dims, params.t_gsw
    k9_takes(params, d)
    kernels.require(W, (3, 8, 2, d), "K9 W")
    kernels.require(V, (3, 8, 2, d), "K9 V")
    kernels.require(g2, (3, params.m2, 2, d), "K9 G2")
    lead = cv.shape[:-5]
    x, B, N = _k9_operand(cv, d, "K9 convert cts")
    if N != nu2 * t:
        raise ValueError(f"K9 convert: {N} cts, want nu_2*t_gsw = "
                         f"{nu2 * t}")
    shape = (B, nu2, 3, params.m2, 2, d)
    q_pos, q_neg = (torch.empty(shape, dtype=torch.int32, device=cv.device)
                    for _ in range(2))
    if B * N:
        kernels.check(kernels.lib().spiral_convert(
            x.data_ptr(), B, nu2, t, W.data_ptr(), V.data_ptr(),
            g2.data_ptr(), q_pos.data_ptr(), q_neg.data_ptr(),
            ntt.kernel_table(d, cv.device).data_ptr(), d, kernels.stream()),
            "spiral_convert")
        kernels.LAUNCHES["convert"] += 1
    return (q_pos.reshape(lead + shape[1:]), q_neg.reshape(lead + shape[1:]))
