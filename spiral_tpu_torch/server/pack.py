"""Packing of the out_n^2 scalar result cts into one (out_n+1) x out_n
matrix ct (counterpart of spiral_tpu/pack.py pack_ciphertexts; ref:
src/testing.cpp:198-241 pack()).

    out[b, c] = sum_r sum_k v_W[r, b, k] * NTT(digit_k(ct_(r,c) row 0))
                + [b >= 1] NTT(ct_(b-1,c) row 1)

with unsigned base-2^bits digits of the m_conv-digit gadget, trial (r, c)
at index r*out_n + c.  On CUDA tensors this is one launch of kernel K7
(csrc/pack.cu, on the register NTT core, d = 256 or 2048), which replaces
the Pallas packing kernel (spiral_tpu/server/pack_pallas.py _pack_call);
on the CPU it runs ``pack_ciphertexts_plain``.  A batch of B queries'
results (a leading query axis) packs in the same single launch, one grid
layer per query.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..arith import ntt
from ..core.gadget import gadget_invert_raw
from ..core.poly import add_raw, matmul_raw


def pack_ciphertexts_plain(result_cts: torch.Tensor,
                           v_W: torch.Tensor) -> torch.Tensor:
    """result_cts ([B,] T = out_n^2, 2, 1, 2, d) coeff; v_W (out_n,
    out_n+1, m_conv, 2, d) NTT -> ([B,] out_n+1, out_n, 2, d) NTT.  The sum
    over the trial row r folds into the contraction over (r, k)."""
    if result_cts.dim() == 6:
        return torch.stack([pack_ciphertexts_plain(r, v_W)
                            for r in result_cts])
    out_n, _, m_conv, _, d = v_W.shape
    ginv = ntt.forward_plain(gadget_invert_raw(result_cts[:, 0:1], m_conv, 1))
    ginv = ginv.reshape(out_n, out_n, m_conv, 1, 2, d)          # [r, c, k]
    keys = v_W.transpose(0, 1).reshape(out_n + 1, out_n * m_conv, 2, d)
    digits = ginv.transpose(0, 1).reshape(out_n, out_n * m_conv, 1, 2, d)
    acc = matmul_raw(keys, digits)[:, :, 0].transpose(0, 1)   # [b, c]
    row1 = ntt.forward_plain(result_cts[:, 1, 0]).reshape(out_n, out_n, 2, d)
    return torch.cat([acc[:1], add_raw(acc[1:], row1)])


def pack_ciphertexts(result_cts: torch.Tensor,
                     v_W: torch.Tensor) -> torch.Tensor:
    if kernels.on_cpu(result_cts, v_W):
        return pack_ciphertexts_plain(result_cts, v_W)
    out_n, _, m_conv, _, d = v_W.shape
    batched = result_cts.dim() == 6
    B = result_cts.shape[0] if batched else 1
    kernels.require(result_cts, (B,) * batched + (out_n * out_n, 2, 1, 2, d),
                    "pack cts")
    kernels.require(v_W, (out_n, out_n + 1, m_conv, 2, d), "pack v_W")
    if out_n not in (2, 4, 8) or not 1 <= m_conv <= 56 or \
            d not in kernels.REG_NTT_DEGREES:
        raise ValueError(f"pack kernel takes out_n 2, 4 or 8, m_conv <= 56 "
                         f"and d in {kernels.REG_NTT_DEGREES}; got v_W "
                         f"{tuple(v_W.shape)}")
    out = torch.empty((B,) * batched + (out_n + 1, out_n, 2, d),
                      dtype=torch.int32, device=v_W.device)
    kernels.check(kernels.lib().spiral_pack(
        result_cts.data_ptr(), v_W.data_ptr(), out.data_ptr(),
        ntt.kernel_table(d, v_W.device).data_ptr(), B, out_n, m_conv, d,
        kernels.stream()), "spiral_pack")
    kernels.LAUNCHES["pack"] += 1
    return out
