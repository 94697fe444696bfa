"""The least time the card could take for the served path's kernels: the
table of peaks and the count of each kernel's bytes and operations.

Frozen copy, at commit 1095982, of chip_smoke.py's bound arithmetic
(HBM_BYTES_PER_S, INT_PRODUCTS_PER_S, INT8_MACS_PER_S,
K2_MACS_PER_PRODUCT, ntt_products, fold_products and check_case's bound:
each input byte read once, each output byte written once, the larger of
bytes over the memory rate and operations over their rate), applied to the
shapes of the served path: K2 (csrc/firstdim.cu) once per query or batch
over the whole encoded database, and K3 / K5 (csrc/fold.cu) once per fold
round.  A later change to the program does not change these counts.
"""
from __future__ import annotations

# H100 SXM: 3.35 TB/s of HBM3; 132 SMs x 64 32-bit integer multiply-adds
# per clock x 1.98 GHz boost, one issue per modular product; the dense
# int8 tensor-core peak, 1,979 TOPS, two operations per multiply-add
HBM_BYTES_PER_S = 3.35e12
INT_PRODUCTS_PER_S = 132 * 64 * 1.98e9
INT8_MACS_PER_S = 1979e12 / 2
# a modular product of two 32-bit words as 16 int8 multiply-adds of 8-bit
# limbs: K2's work at the card's cheapest exact route
K2_MACS_PER_PRODUCT = 16
WORD_BYTES = 4


def bound_s(nbytes: int, products: int = 0, int8_macs: int = 0) -> float:
    """The larger of the bytes' time and the operations' time."""
    return max(nbytes / HBM_BYTES_PER_S, products / INT_PRODUCTS_PER_S,
               int8_macs / INT8_MACS_PER_S)


def ntt_products(d: int) -> int:
    """Modular products of one length-d NTT: the (un)twist and the d/2
    butterflies of each of the log2(d) stages."""
    return d + d // 2 * (d.bit_length() - 1)


def fold_products(m_out: int, n1: int, n2: int, t: int, d: int) -> int:
    """K3 / K5 round: per (output ct, column, limb) 2*n1*t digit NTTs, each
    slot multiplied into n1 rows, and n1 inverse NTTs."""
    per = 2 * n1 * t * (ntt_products(d) + n1 * d) + n1 * ntt_products(d)
    return m_out * n2 * 2 * per


def k2_s(p, factor: int, batch: int) -> float:
    """One K2 call: the database (2, d, K, F*num_per*n2) and B queries' (2,
    d, K, B*n1) words read, (2, d, B, n1, F*num_per*n2) written; 16 int8
    multiply-adds per modular product."""
    d, K = p.poly_len, p.dim0 * p.n0
    m = factor * p.num_per * p.n2
    nbytes = WORD_BYTES * (2 * d * K * m + 2 * d * K * batch * p.n1 +
                           2 * d * batch * p.n1 * m)
    macs = K2_MACS_PER_PRODUCT * 2 * d * K * m * batch * p.n1
    return bound_s(nbytes, int8_macs=macs)


def fold_s(p, factor: int, batch: int) -> float:
    """The nu_2 fold rounds of B queries over F*num_per first-dimension
    cts, summed: round r reads 2*m_out cts (n1, n2, 2, d) and the query's
    two GSW matrices (n1, n1*t_gsw, 2, d), writes m_out cts."""
    d, n1, n2, t = p.poly_len, p.n1, p.n2, p.t_gsw
    ct = n1 * n2 * 2 * d
    gsw = n1 * n1 * t * 2 * d
    total, cts = 0.0, factor * p.num_per
    for _ in range(p.nu_2):
        m_out = cts // 2
        nbytes = WORD_BYTES * batch * (2 * m_out * ct + 2 * gsw + m_out * ct)
        total += bound_s(nbytes,
                         products=batch * fold_products(m_out, n1, n2, t, d))
        cts = m_out
    return total
