"""Public key material (counterpart of spiral_tpu/crypto/publicparams.py):
W_exp_left/right key-switch the expansion automorphisms, W_conv composes,
V converts Regev to GSW.  A query whose parts are all uploaded directly
(SpiralStream) is not expanded, and its W_exp_* are None."""
from __future__ import annotations

import dataclasses

import torch

from ..params import LOG_Q, Params
from ..arith import ntt
from ..core.gadget import build_gadget
from ..core.poly import automorph_raw, matmul_raw, scalar_mul_raw
from .encrypt import Encryptor


@dataclasses.dataclass
class PublicParams:
    W_exp_left: list | None   # g tensors (2, m_exp, 2, d), NTT
    W_exp_right: list | None  # tensors (2, m_exp_right, 2, d), NTT
    W_conv: torch.Tensor  # (n1, n0*m_conv, 2, d), NTT
    V: torch.Tensor       # (n1, 2*m_conv, 2, d), NTT
    size_bytes: int = 0   # the JAX accounting; the wire size from bytes


def matrix_bytes(m: torch.Tensor) -> int:
    """A key matrix (rows, cols, 2, d) counted as rows*cols polys of d
    56-bit coefficients (publicparams.py _pub_size)."""
    return m.shape[0] * m.shape[1] * m.shape[-1] * LOG_Q // 8


def expansion_keyswitch_matrices(enc: Encryptor, rounds: int, m_exp: int,
                                 d: int) -> list:
    """W[r] = Enc_sr(tau_t(sr) * G_exp), t = d/2^r + 1."""
    G_exp = ntt.forward(build_gadget(1, m_exp, d, enc.device))
    out = []
    for r in range(rounds):
        tau = ntt.forward(automorph_raw(enc.keys.sr, (d >> r) + 1))
        out.append(enc.encrypt_simple_regev_matrix(
            scalar_mul_raw(tau[0, 0], G_exp)))
    return out


def expansion_rounds(params: Params) -> tuple[int, int]:
    """(g, right_rounds): the rounds of W_exp_left and of W_exp_right
    (publicparams.py _pub_inner).  With an expansion plan, g is the
    largest g of its expanded parts, 0 when both are uploaded directly."""
    plan = params.expansion_plan()
    if plan is None:
        g, stop = params.g, params.stopround
        return g, (stop + 1 if stop > 0 else g)
    g = max((plan[part]["g"] for part in ("first", "rest")
             if not plan[part]["direct"]), default=0)
    return g, g


def generate_public_params(params: Params, enc: Encryptor) -> PublicParams:
    """V is made even where the rest part is uploaded directly: the server
    converts those cts with it, as the JAX server does (pir.py:190-196),
    though the JAX size accounting leaves V out there.  size_bytes is that
    accounting (publicparams.py:108-118): W_conv, the W_exp_* where a part
    is expanded, and V unless the rest part is uploaded directly."""
    d, dev = params.poly_len, enc.device
    g, right_rounds = expansion_rounds(params)
    W_left = W_right = None
    if g > 0:
        W_left = expansion_keyswitch_matrices(enc, g, params.m_exp, d)
        W_right = expansion_keyswitch_matrices(enc, right_rounds,
                                               params.m_exp_right, d)
    sr_ntt = ntt.forward(enc.keys.sr)[0, 0]
    G_scale = ntt.forward(build_gadget(params.n0, params.n0 * params.m_conv,
                                       d, dev))
    W_conv = enc.encrypt_matrix(scalar_mul_raw(sr_ntt, G_scale))
    gv = ntt.forward(build_gadget(1, params.m_conv, d, dev))
    together = torch.cat([scalar_mul_raw(sr_ntt, gv), gv], dim=1)
    V = enc.encrypt_matrix(matmul_raw(ntt.forward(enc.keys.Sp), together))
    size = matrix_bytes(W_conv) + sum(map(matrix_bytes,
                                          (W_left or []) + (W_right or [])))
    if not params.direct_upload_rest:
        size += matrix_bytes(V)
    return PublicParams(W_exp_left=W_left, W_exp_right=W_right,
                        W_conv=W_conv, V=V, size_bytes=size)
