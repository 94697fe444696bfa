"""Scheme parameters and presets: the port's own copy of
spiral_tpu/params.py (pure Python), so the port never imports the JAX
package.  ``Params`` is a frozen dataclass of every knob with its derived
quantities; ``PRESETS`` holds the named configurations.  The two packages'
Params have the same fields, so either converts to the other with
``dataclasses.asdict``.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

# CRT modulus pair, Q = P_I * B_I ~ 2^56 (ref: include/values.h:13,21,41)
P_I = 268369921  # 2^28 - 2^16 + 1
B_I = 249561089  # 2^28 - 2^21 - 2^12 + 1
Q = P_I * B_I
LOG_Q = 56

# NTT-friendly moduli usable as the modulus-switch target q', indexed by bit
# width (ref: include/values.h:74-76).
QPRIME_MODS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 12289, 12289, 61441, 65537,
    65537, 520193, 786433, 786433, 3604481, 7340033, 16515073, 33292289,
    67043329, 132120577, 268369921, 469762049, 1073479681, 2013265921,
    4293918721, 8588886017, 17175674881, 34359214081, 68718428161,
]


def get_bits_per(dim: int) -> int:
    """Gadget digit width for a gadget with `dim` digits (ref: util.h:34-38)."""
    if dim == LOG_Q:
        return 1
    return LOG_Q // dim + 1


@dataclasses.dataclass(frozen=True)
class Params:
    """All scheme parameters (ref: include/values.h:67-93 + CLI dims)."""

    nu_1: int = 2              # log2 of first ("expanded") dimension
    nu_2: int = 2              # number of folded dimensions
    p_db: int = 256            # plaintext modulus
    q_prime_bits: int = 20     # modulus-switch target width for response row 0
    t_gsw: int = 8             # GSW gadget digits
    t_conv: int = 4            # conversion gadget digits (m_conv)
    t_exp: int = 8             # expansion gadget digits, first-dim slots (m_exp)
    t_exp_right: int = 8       # expansion gadget digits, GSW slots (m_exp_right)
    poly_len: int = 2048       # ring degree d
    # Matrix dimensions (ref: values.h:67-72)
    n0: int = 2
    n1: int = 3
    n2: int = 2
    out_n: int = 2             # pack variant output dimension
    # Query upload structure (ref: values.h:78-79). query_elems_first >= 2^nu_1
    # means the first-dim Regev cts are uploaded directly; query_elems_rest >=
    # nu_2*t_gsw means the GSW-source cts are uploaded directly (SpiralStream).
    query_elems_first: int = 1
    query_elems_rest: int = 0
    ternary: bool = False      # ternary secrets instead of gaussian
    seed: int = 0

    # ---- derived quantities -------------------------------------------------
    @property
    def k_param(self) -> int:
        return self.n1 - self.n0

    @property
    def base_dim(self) -> int:
        return 2

    @property
    def crt_count(self) -> int:
        return 2

    @property
    def m2(self) -> int:
        return self.t_gsw * self.n1

    @property
    def m_conv(self) -> int:
        return self.t_conv

    @property
    def m_exp(self) -> int:
        return self.t_exp

    @property
    def m_exp_right(self) -> int:
        return self.t_exp_right

    @property
    def arb_qprime(self) -> int:
        return QPRIME_MODS[self.q_prime_bits]

    @property
    def bits_to_hold_arb_qprime(self) -> int:
        return self.q_prime_bits

    @property
    def scale_k(self) -> int:
        """Delta = Q / p (ref: values.h:93)."""
        return Q // self.p_db

    @property
    def dim0(self) -> int:
        return 1 << self.nu_1

    @property
    def further_dims(self) -> int:
        return self.nu_2

    @property
    def num_per(self) -> int:
        return 1 << self.nu_2

    @property
    def total_n(self) -> int:
        return self.dim0 * self.num_per

    @property
    def direct_upload_first(self) -> bool:
        return self.query_elems_first >= self.dim0

    @property
    def direct_upload_rest(self) -> bool:
        return self.query_elems_rest >= self.further_dims * self.t_gsw

    def expansion_plan(self):
        """Subround structure (ref: src/spiral.cpp:2058-2080).

        Returns None for the single-packed-ct path (query_elems_rest == 0,
        stopround trick).  Otherwise a dict per part with
        {direct: bool, n_cts: int, g: int, bits: int}: the client uploads
        n_cts scalar cts; non-direct parts expand each ct into 2^g slots
        of which `bits` are used.
        """
        if self.query_elems_rest == 0:
            return None
        ell_total = self.t_gsw * self.further_dims
        qe_f = max(1, self.query_elems_first)
        qe_r = self.query_elems_rest

        def part(direct, total, qe):
            if direct:
                return {"direct": True, "n_cts": total, "g": 0,
                        "bits": total}
            assert total % qe == 0, (total, qe)
            bits = total // qe
            return {"direct": False, "n_cts": qe,
                    "g": max(1, math.ceil(math.log2(bits))), "bits": bits}

        return {
            "first": part(qe_f >= self.dim0, self.dim0, qe_f),
            "rest": part(qe_r >= ell_total, ell_total, qe_r),
        }

    @property
    def g(self) -> int:
        """Expansion rounds (ref: src/spiral.cpp:2078-2080)."""
        num_bits_to_gen = self.t_gsw * self.further_dims + self.dim0
        return max(1, math.ceil(math.log2(num_bits_to_gen)))

    @property
    def stopround(self) -> int:
        """Early-stop round for GSW slots (ref: src/spiral.cpp:2083-2084)."""
        stop = math.ceil(math.log2(self.t_gsw * self.further_dims))
        if self.t_gsw * self.further_dims > self.dim0:
            return 0
        return stop

    # ---- communication sizes (bytes) ---------------------------------------
    @property
    def bytes_per_poly(self) -> int:
        return self.poly_len * LOG_Q // 8

    def query_size_bytes(self) -> int:
        """Online query size: one seed-compressed polynomial per uploaded
        scalar ct (matches the reference's reported sizes, e.g.
        exp_lut.json query_sz = 14,336 B for the packed query)."""
        plan = self.expansion_plan()
        if plan is None:
            return self.bytes_per_poly
        return (plan["first"]["n_cts"] + plan["rest"]["n_cts"]) * \
            self.bytes_per_poly

    def public_param_size_bytes(self) -> int:
        """Offline public-parameter bytes (matches the accounting in
        crypto/publicparams.py; ref: add_pub_param at src/spiral.cpp
        runConversionImproved)."""
        per = self.poly_len * LOG_Q // 8
        size = self.n1 * self.n0 * self.m_conv * per          # W_conv
        plan = self.expansion_plan()
        if plan is None:
            g = self.g
            right = (self.stopround + 1) if self.stopround > 0 else g
        else:
            g = max((plan[part]["g"] for part in ("first", "rest")
                     if not plan[part]["direct"]), default=0)
            right = g
        if g > 0:
            size += g * self.base_dim * self.m_exp * per      # W_exp_left
            size += right * self.base_dim * self.m_exp_right * per
        if not self.direct_upload_rest:
            size += self.n1 * 2 * self.m_conv * per           # V
        return size

    def response_size_bytes(self) -> int:
        """Two-modulus modswitched response (ref: src/spiral.cpp:230-234)."""
        pt_mod = math.log2(self.p_db)
        n0, d = self.n0, self.poly_len
        return int((n0 * n0 * d * (pt_mod + 2) + n0 * d * self.q_prime_bits) // 8)

    def validate(self) -> None:
        assert self.poly_len & (self.poly_len - 1) == 0
        assert (P_I - 1) % (2 * self.poly_len) == 0
        assert (B_I - 1) % (2 * self.poly_len) == 0
        assert self.n1 == self.n0 + self.k_param
        assert self.p_db & (self.p_db - 1) == 0
        assert self.arb_qprime != 0, "unsupported q_prime_bits"


# Parameter presets for the paper's scenarios.  The primary presets are
# REGENERATED from the committed parameter-search artifact
# (python -m spiral_tpu.paramgen.sweep; selection via
# paramgen.search.select_params) and pass the 2^-40 correctness model
# (paramgen/noise.py, bit-exact vs the reference model — verified by
# tests/test_paramgen.py).  The `*_paper` aliases carry the reference's
# recorded choices (ref: all_parameter_choices.txt:67-98,658-719) for
# baseline comparability; note the paper's (20,256) Spiral choice
# (t_gsw=8, q'=2^20) predates a noise-model revision and evaluates to
# p_err ~ 2^-14 under the current (reference) model.
PRESETS = {
    # 2^20 x 256 B scenarios (items packed into n0*n2 poly records),
    # model-selected (see above; artifact rows carry p_err <= 2^-40)
    "spiral_20_256": Params(nu_1=8, nu_2=7, p_db=256, q_prime_bits=22,
                            t_gsw=9, t_conv=4, t_exp=8, t_exp_right=56),
    "spiralstream_20_256": Params(nu_1=9, nu_2=6, p_db=256, q_prime_bits=20,
                                  t_gsw=5, t_conv=4, t_exp=8, t_exp_right=56,
                                  query_elems_first=1 << 9,
                                  query_elems_rest=6 * 5),
    "spiralpack_20_256": Params(nu_1=6, nu_2=7, p_db=256, q_prime_bits=20,
                                t_gsw=9, t_conv=4, t_exp=8, t_exp_right=56,
                                out_n=4),
    "spiralstreampack_20_256": Params(nu_1=6, nu_2=6, p_db=65536,
                                      q_prime_bits=28, t_gsw=3, t_conv=56,
                                      t_exp=56, t_exp_right=56, out_n=4,
                                      query_elems_first=1 << 6,
                                      query_elems_rest=6 * 3),
    # the paper's recorded parameter choices (baseline parity)
    "spiral_20_256_paper": Params(nu_1=8, nu_2=7, p_db=256, q_prime_bits=20,
                                  t_gsw=8, t_conv=4, t_exp=8,
                                  t_exp_right=56),
    "spiralstream_20_256_paper": Params(nu_1=9, nu_2=6, p_db=256,
                                        q_prime_bits=19, t_gsw=5, t_conv=4,
                                        t_exp=2, t_exp_right=2,
                                        query_elems_first=1 << 9,
                                        query_elems_rest=6 * 5),
    "spiralpack_20_256_paper": Params(nu_1=9, nu_2=6, p_db=256,
                                      q_prime_bits=20, t_gsw=8, t_conv=4,
                                      t_exp=8, t_exp_right=56, out_n=2),
    "spiralstreampack_20_256_paper": Params(nu_1=10, nu_2=3, p_db=1024,
                                            q_prime_bits=21, t_gsw=2,
                                            t_conv=56, t_exp=56,
                                            t_exp_right=56, out_n=4,
                                            query_elems_first=1 << 10,
                                            query_elems_rest=3 * 2),
    # Huge-database timing configs (implicit working-set mode, ref:
    # --random-data): 2^22..2^28 x 256 B items = 2^18..2^24 records.
    # Model-selected like the headline presets (all pass the 2^-40 bar).
    "spiral_22_256": Params(nu_1=9, nu_2=9, p_db=256, q_prime_bits=22,
                            t_gsw=11, t_conv=4, t_exp=8, t_exp_right=56),
    "spiral_24_256": Params(nu_1=9, nu_2=11, p_db=256, q_prime_bits=22,
                            t_gsw=11, t_conv=4, t_exp=16, t_exp_right=56),
    "spiral_26_256": Params(nu_1=10, nu_2=12, p_db=256, q_prime_bits=22,
                            t_gsw=12, t_conv=4, t_exp=16, t_exp_right=56),
    "spiral_28_256": Params(nu_1=11, nu_2=13, p_db=256, q_prime_bits=22,
                            t_gsw=13, t_conv=4, t_exp=32, t_exp_right=56),
    # small/fast configs for tests
    "tiny": Params(nu_1=2, nu_2=2, p_db=256, q_prime_bits=20, t_gsw=8,
                   t_conv=4, t_exp=8, t_exp_right=8, poly_len=256),
    "tiny_stream": Params(nu_1=2, nu_2=2, p_db=256, q_prime_bits=20, t_gsw=8,
                          t_conv=4, t_exp=8, t_exp_right=8, poly_len=256,
                          query_elems_first=4, query_elems_rest=16),
    "tiny_subround": Params(nu_1=3, nu_2=2, p_db=256, q_prime_bits=20,
                            t_gsw=8, t_conv=4, t_exp=8, t_exp_right=8,
                            poly_len=256, query_elems_first=2,
                            query_elems_rest=4),
    "tiny_pack": Params(nu_1=2, nu_2=2, p_db=256, q_prime_bits=20, t_gsw=8,
                        t_conv=4, t_exp=8, t_exp_right=8, poly_len=256,
                        out_n=2),
    "tiny_pack4": Params(nu_1=2, nu_2=2, p_db=256, q_prime_bits=20, t_gsw=8,
                         t_conv=4, t_exp=8, t_exp_right=8, poly_len=256,
                         out_n=4),
    "tiny_stream_pack_bigp": Params(nu_1=2, nu_2=2, p_db=65536,
                                    q_prime_bits=28, t_gsw=8, t_conv=16,
                                    t_exp=8, t_exp_right=8, poly_len=256,
                                    out_n=4, query_elems_first=4,
                                    query_elems_rest=16),
    "tiny_stream_pack": Params(nu_1=2, nu_2=2, p_db=256, q_prime_bits=20,
                               t_gsw=8, t_conv=4, t_exp=8, t_exp_right=8,
                               poly_len=256, out_n=2,
                               query_elems_first=4, query_elems_rest=16),
    # out_n=8: the largest packing width the search artifact emits for
    # plain pack shapes (paramgen/sweep.py out_n grid)
    "tiny_pack8": Params(nu_1=2, nu_2=2, p_db=256, q_prime_bits=20,
                         t_gsw=8, t_conv=4, t_exp=8, t_exp_right=8,
                         poly_len=256, out_n=8),
    # the paper's SpiralStreamPack gadget widths (t_conv=t_exp=56,
    # t_gsw=2, n=4, p=1024 — BASELINE.md 2^20x256 row) on a tiny ring
    "tiny_stream_pack_paper": Params(nu_1=3, nu_2=2, p_db=1024,
                                     q_prime_bits=21, t_gsw=2, t_conv=56,
                                     t_exp=56, t_exp_right=56,
                                     poly_len=256, out_n=4,
                                     query_elems_first=8,
                                     query_elems_rest=8),
}


@lru_cache(maxsize=None)
def preset(name: str) -> Params:
    p = PRESETS[name]
    p.validate()
    return p
