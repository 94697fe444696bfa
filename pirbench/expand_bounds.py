"""The least time the card could take for one query's K4 launches (the
expansion's key switches, csrc/expand.cu).

Frozen copy, at commit 7d44317, of chip_smoke.py's expand_products,
expand_launches and time_expand_launches' bytes (check_case's rule: each
input byte read once, each output byte written once; a launch's bound is
the larger of its bytes over the memory rate and its modular products
over their rate, bounds.py's peaks), applied to a configuration's
parameters.  A later change to the program does not change these counts.
"""
from __future__ import annotations

from .bounds import WORD_BYTES, bound_s, ntt_products


def expand_products(N: int, m: int, d: int) -> int:
    """K4 launch: per (ct, limb) m digit NTTs, each slot multiplied into
    two rows, and the NTT of row 1."""
    return N * 2 * (m * (ntt_products(d) + 2 * d) + ntt_products(d))


def expand_launches(p) -> list[tuple[str, int, int, int]]:
    """The K4 launches of one query, in the order coefficient_expansion
    makes them: (side, round, cts N, digits m).  Odd slots stop after the
    stopround, where only the first t_gsw * nu_2 + 1 are switched."""
    out = []
    for r in range(p.g):
        out.append(("even", r, 1 << r, p.t_exp))
        if p.stopround == 0 or r <= p.stopround:
            n = 1 << r
            if p.stopround > 0 and r == p.stopround:
                n = min(n, p.t_gsw * p.nu_2 + 1)
            out.append(("odd", r, n, p.t_exp_right))
    return out


def launch_bytes(N: int, m: int, d: int) -> int:
    """A launch reads N cts and N automorphed cts (N, 2, 1, 2, d) and the
    key (2, m, 2, d), and writes N cts."""
    return WORD_BYTES * (3 * N * 2 * 2 * d + 2 * m * 2 * d)


def k4_s(p) -> float:
    """One query's K4 launches, each bound alone, summed."""
    d = p.poly_len
    return sum(bound_s(launch_bytes(N, m, d), expand_products(N, m, d))
               for _, _, N, m in expand_launches(p))
