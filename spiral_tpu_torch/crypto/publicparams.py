"""Public key material (counterpart of spiral_tpu/crypto/publicparams.py),
single packed-query form: W_exp_left/right key-switch the expansion
automorphisms, W_conv composes, V converts Regev to GSW."""
from __future__ import annotations

import dataclasses

import torch

from ..params import Params
from ..arith import ntt
from ..core.gadget import build_gadget
from ..core.poly import automorph_raw, matmul_raw, scalar_mul_raw
from .encrypt import Encryptor


@dataclasses.dataclass
class PublicParams:
    W_exp_left: list     # g tensors (2, m_exp, 2, d), NTT
    W_exp_right: list    # tensors (2, m_exp_right, 2, d), NTT
    W_conv: torch.Tensor  # (n1, n0*m_conv, 2, d), NTT
    V: torch.Tensor       # (n1, 2*m_conv, 2, d), NTT


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


def generate_public_params(params: Params, enc: Encryptor) -> PublicParams:
    if params.expansion_plan() is not None:
        raise NotImplementedError("only the packed one-ct query form")
    d, dev = params.poly_len, enc.device
    g, stop = params.g, params.stopround
    right_rounds = stop + 1 if stop > 0 else g
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
    return PublicParams(W_exp_left=W_left, W_exp_right=W_right,
                        W_conv=W_conv, V=V)
