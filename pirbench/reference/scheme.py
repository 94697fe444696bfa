"""The scheme's parameters and constants, as the plain client reads them.

Frozen copy of spiral_tpu_torch/params.py at commit 1095982 (the CRT
moduli, QPRIME_MODS, get_bits_per and the Params fields and derived
quantities a client uses).  It is the yardstick of the benchmark: later
changes to the program do not change it.  ``SchemeParams.from_config``
builds it from a configuration file's ``params`` object, so the client
never reads the program's presets.
"""
from __future__ import annotations

import dataclasses
import math

P_I = 268369921  # 2^28 - 2^16 + 1
B_I = 249561089  # 2^28 - 2^21 - 2^12 + 1
Q = P_I * B_I
LOG_Q = 56
P_INV_MOD_B = pow(P_I, B_I - 2, B_I)

QPRIME_MODS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 12289, 12289, 61441, 65537,
    65537, 520193, 786433, 786433, 3604481, 7340033, 16515073, 33292289,
    67043329, 132120577, 268369921, 469762049, 1073479681, 2013265921,
    4293918721, 8588886017, 17175674881, 34359214081, 68718428161,
]


def get_bits_per(dim: int) -> int:
    """Gadget digit width for a gadget with `dim` digits."""
    if dim == LOG_Q:
        return 1
    return LOG_Q // dim + 1


@dataclasses.dataclass(frozen=True)
class SchemeParams:
    nu_1: int
    nu_2: int
    p_db: int
    q_prime_bits: int
    t_gsw: int
    t_conv: int
    t_exp: int
    t_exp_right: int
    poly_len: int
    n0: int
    n1: int
    n2: int
    out_n: int
    query_elems_first: int
    query_elems_rest: int
    ternary: bool
    seed: int

    @classmethod
    def from_config(cls, fields: dict) -> "SchemeParams":
        names = {f.name for f in dataclasses.fields(cls)}
        if set(fields) != names:
            raise ValueError(f"params fields {sorted(fields)} are not "
                             f"{sorted(names)}")
        return cls(**fields)

    @property
    def k_param(self) -> int:
        return self.n1 - self.n0

    @property
    def arb_qprime(self) -> int:
        return QPRIME_MODS[self.q_prime_bits]

    @property
    def scale_k(self) -> int:
        return Q // self.p_db

    @property
    def dim0(self) -> int:
        return 1 << self.nu_1

    @property
    def num_per(self) -> int:
        return 1 << self.nu_2

    @property
    def total_n(self) -> int:
        return self.dim0 * self.num_per

    @property
    def g(self) -> int:
        return max(1, math.ceil(math.log2(self.t_gsw * self.nu_2 +
                                          self.dim0)))

    @property
    def stopround(self) -> int:
        if self.t_gsw * self.nu_2 > self.dim0:
            return 0
        return math.ceil(math.log2(self.t_gsw * self.nu_2))

    @property
    def response_widths(self) -> tuple[int, int]:
        """Bits a coefficient of row 0 and of the other rows takes on the
        wire."""
        return self.q_prime_bits, int(math.log2(4 * self.p_db))
