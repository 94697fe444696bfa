"""Closed-form noise-growth and correctness models (the port's copy of
spiral_tpu/paramgen/noise.py, pure float math in the same order, so every
result equals the JAX package's).

Port of the reference's analytical machinery (ref:
generate_all_schemes.py:16-142 calc_fast / calc_fast_highrate and
:165-190 get_p_err_fast_highrate).  The models bound the final response
noise variance after expansion -> conversion -> first-dim -> folding
(-> packing), and the subgaussian tail probability that rounded decoding
fails, targeting P[err] <= 2^-40 per the paper.
"""
from __future__ import annotations

import math

from ..params import QPRIME_MODS, Q, Params

P_ERR_BITS = 40.0
SIGMA = 6.4  # gaussian parameter (width), matches core/sampling.py


# q_1 = 4p modswitch targets use slightly-reduced moduli for large p
# (ref: generate_all_schemes.py:144-163)
_P_MOD_TABLE = {
    17: 131072, 18: 262144, 19: 524288, 20: 1048576, 21: 2097152,
    22: 4194304, 23: 8388592, 24: 16777184, 25: 33554332, 26: 67108804,
    27: 134217608, 28: 268435216, 29: 536742296, 30: 1073612276,
}


def get_real_p(p: int) -> int:
    bits = p.bit_length() - 1
    if bits <= 16:
        return p
    return _P_MOD_TABLE[bits]


def noise_variance(params: Params, q: int = Q, sigma: float = SIGMA,
                   C: float = 5.0, m_pt: int = 1) -> float:
    """Final response noise variance for the main variant
    (ref: generate_all_schemes.py:16-72 calc_fast)."""
    n, d = params.n0, params.poly_len
    p_db = params.p_db
    t_gsw, t_conv = params.t_gsw, params.t_conv
    t_exp, t_exp_right = params.t_exp, params.t_exp_right
    nu_1, nu_2 = params.nu_1, params.nu_2

    z_gsw = math.ceil(q ** (1.0 / t_gsw))
    m_gsw = (n + 1) * t_gsw
    z_exp = math.ceil(q ** (1.0 / t_exp))
    z_conv = math.ceil(q ** (1.0 / t_conv))
    z_exp_right = math.ceil(q ** (1.0 / t_exp_right))
    B = 1.0 if params.ternary else C * sigma

    du_first = params.direct_upload_first
    du_rest = params.direct_upload_rest

    num_exp_reg = 0 if du_first else nu_1 + 1 + (m_pt - 1)
    noise_scale_gsw = 4 * (t_gsw * nu_2 + 1) ** 2

    sigma_hat_regev_2 = (4 ** num_exp_reg) * sigma ** 2 * (
        1 + d * t_exp * z_exp ** 2 / 3)
    if du_first:
        sigma_hat_regev_2 = sigma ** 2
    sigma_regev_2 = sigma_hat_regev_2 + \
        d * t_conv * z_conv ** 2 * sigma ** 2 / 4.0

    sigma_hat_gsw_2 = noise_scale_gsw * sigma ** 2 * (
        1 + t_exp_right * d * z_exp_right ** 2 / 3)
    if du_rest:
        sigma_hat_gsw_2 = sigma ** 2
    sigma_gsw_2 = sigma_hat_gsw_2 * d * B ** 2 + \
        t_conv * d * sigma ** 2 * z_conv ** 2 / 2

    sigma_0_2 = (2 ** nu_1) * n * d * m_pt * \
        (p_db ** (1 / m_pt) / 2) ** 2 * sigma_regev_2
    sigma_rest = nu_2 * d * m_gsw * z_gsw ** 2 / 2 * sigma_gsw_2
    return sigma_0_2 + sigma_rest


def noise_variance_highrate(params: Params, q: int = Q, sigma: float = SIGMA,
                            C: float = 5.0) -> float:
    """Pack variant (ref: generate_all_schemes.py:94-142
    calc_fast_highrate)."""
    d = params.poly_len
    n = 1
    true_n = params.out_n
    p_db = params.p_db
    t_gsw, t_conv = params.t_gsw, params.t_conv
    t_exp, t_exp_right = params.t_exp, params.t_exp_right
    nu_1, nu_2 = params.nu_1, params.nu_2

    z_gsw = math.ceil(q ** (1.0 / t_gsw))
    m_gsw = (n + 1) * t_gsw
    z_conv = math.ceil(q ** (1.0 / t_conv))
    z_exp = math.ceil(q ** (1.0 / t_exp))
    z_exp_right = math.ceil(q ** (1.0 / t_exp_right))

    if params.direct_upload_first:
        sigma_regev_2 = sigma ** 2
        sigma_gsw_2 = sigma ** 2
    else:
        noise_scale_gsw = 4 ** (math.ceil(math.log2(t_gsw * nu_2)) + 1)
        sigma_regev_2 = (4 ** (nu_1 + 1)) * sigma ** 2 * (
            1 + d * t_exp * z_exp ** 2 / 3)
        sigma_gsw_2 = noise_scale_gsw * sigma ** 2 * (
            1 + t_exp_right * d * z_exp_right ** 2 / 3)
        sigma_gsw_2 = sigma_gsw_2 * d * (C * sigma) ** 2 + \
            t_conv * d * sigma ** 2 * z_conv ** 2 / 2

    sigma_0_2 = (2 ** nu_1) * n * d * (p_db / 2) ** 2 * sigma_regev_2
    sigma_rest = nu_2 * d * m_gsw * z_gsw ** 2 / 2 * sigma_gsw_2
    sigma_packing_2 = d * true_n * t_conv * sigma ** 2 * z_conv ** 2 / 4
    return sigma_0_2 + sigma_rest + sigma_packing_2


def p_err_bits(p: int, q_prime: int, s_e: float, q: int = Q, n: int = 2,
               d: int = 2048, sigma: float = SIGMA) -> float:
    """log2 of decode-failure probability under the two-modulus switch
    (ref: generate_all_schemes.py:165-190 get_p_err_fast_highrate)."""
    pf = float(get_real_p(int(p)))
    q_mod_p = q % pf
    modswitch_adj = (1.0 / 8.0) * (4 * pf * q_mod_p / q)
    thresh = 0.25 - modswitch_adj
    assert 0 < thresh <= 0.25, (thresh, p)

    s_round_2 = sigma ** 2 * d / 4
    numer = -math.pi * thresh ** 2
    denom = s_e * (pf / q) ** 2 + s_round_2 * (pf / q_prime) ** 2
    p_single_err_log = math.log(2) + numer / denom
    pr_err_log = p_single_err_log + math.log(n * n * d)
    return pr_err_log * math.log2(math.e)


def min_qprime_bits(params: Params, s_e: float, n: int | None = None,
                    target_bits: float = P_ERR_BITS) -> int | None:
    """Smallest q' bit width meeting the correctness bar (the reference
    sweeps fractional bits, generate_all_schemes.py:225-234; we return the
    matching NTT-friendly width from the qprime table)."""
    n = params.n0 if n is None else n
    for bits in range(14, len(QPRIME_MODS)):
        qp = QPRIME_MODS[bits]
        if qp == 0 or qp <= 2 * params.p_db:
            continue
        if p_err_bits(params.p_db, qp, s_e, n=n,
                      d=params.poly_len) <= -target_bits:
            return bits
    return None
