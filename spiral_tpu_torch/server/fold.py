"""GSW external-product folding (counterpart of spiral_tpu/server/fold.py
and of the pack fold in spiral_tpu/pack.py).

Each round halves the ciphertexts with the homomorphic mux
C <- q_neg . G^{-1}(C_even) + q_pos . G^{-1}(C_odd).  Rows are in
bit-reversed further-index order, so a round pairs adjacent cts (2o, 2o+1).

Spiral folds matrix cts with signed gadget digits: on CUDA tensors a round
is one launch of kernel K3 (csrc/fold.cu), which replaces the Pallas fold
round (spiral_tpu/server/fold_pallas.py _fold_round_call, signed); on the
CPU it runs ``fold_round_plain``.  The pack variant folds scalar cts of
out_n^2 trials with unsigned digits: kernel K6, the same CUDA kernel
instantiated for two rows and unsigned digits, which replaces the same
Pallas round called unsigned (fold_pack_rounds_fused); on the CPU
``fold_pack_round_plain``.

A batch of B queries folds in one launch per round of kernel K5, the same
kernel with each output ct reading its own query's q block, which replaces
the Pallas batched round (fold_pallas.py _fold_round_call_batch, through
fold_rounds_fused_batch and fold_pack_rounds_fused_batch).  The plain
versions take the leading query axis as it is.

The single-query Spiral fold picks each round's kernels from the round's
shape (``round_uses_mxu``: the large rounds at t_gsw 11, where K8b was
measured faster, run K8b, the others K3): K3, or the counterpart of the JAX SPIRAL_FOLD=mxu path (fold_pallas.py
fold_rounds_mxu), three launches:
  ``fold_ntt``: kernel K8b-1 (csrc/fold_mxu.cu), replacing the Pallas
    _fold_ntt_call, writes the signed digits of every ct pair after the
    forward NTT (K3's digit stage on the register NTT), G (2 li, 2 s,
    t_gsw, m_out, n1*n2, d) in mxu order, into the server's buffer
    (``mxu_workspace``, made once);
  ``fold_contract``: kernel K8b-2, replacing JAX's XLA contraction
    _fold_contract_mxu with its prescale _fold_qpre, contracts G with the
    round's q on the int8 tensor cores, slot by slot, G's words used as
    stored as four 8-bit limbs against the query's prescaled limbs;
  ``ntt.inverse`` (K1).
The TPU forms 7-bit digits with an int8 bias, because its NTT is an int8
matmul, and undoes it with a correction term (fold_pallas.py
_fold_bias_corr); K8b-1 transforms exact signed-digit residues, as K3
does, so G carries no bias and the contraction needs no correction.  The
round's output equals K3's, and JAX's, bit for bit.  On the CPU the three
run ``fold_ntt_plain``, ``fold_contract_plain`` (JAX's 7-bit limb
scheme in int64; ``fold_contract_limb_sums`` also takes the kernel's
8-bit limbs) and the plain inverse NTT.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..params import Params
from .. import kernels
from ..arith import ntt
from ..arith.mod import MODS, p_col
from ..core.gadget import gadget_invert_raw, gadget_invert_signed_raw
from ..core.poly import add_raw, matmul_raw


def _even_odd(cts: torch.Tensor):
    """Split the ct axis (-5) of (..., 2m, r, c, 2, d) into the pairs'
    even and odd members, each (..., m, r, c, 2, d)."""
    return cts.unflatten(-5, (-1, 2)).unbind(-5)


def fold_round_plain(cts: torch.Tensor, q_neg: torch.Tensor,
                     q_pos: torch.Tensor, t_gsw: int) -> torch.Tensor:
    """cts ([B,] 2m, n1, n2, 2, d) coeff; q_neg/q_pos ([B,] n1, t_gsw*n1,
    2, d) NTT -> ([B,] m, n1, n2, 2, d) coeff."""
    n1 = cts.shape[-4]
    even, odd = _even_odd(cts)
    g_even = ntt.forward_plain(gadget_invert_signed_raw(even, t_gsw, n1))
    g_odd = ntt.forward_plain(gadget_invert_signed_raw(odd, t_gsw, n1))
    return ntt.inverse_plain(add_raw(matmul_raw(q_neg.unsqueeze(-5), g_even),
                                     matmul_raw(q_pos.unsqueeze(-5), g_odd)))


def fold_round(cts: torch.Tensor, q_neg: torch.Tensor, q_pos: torch.Tensor,
               t_gsw: int) -> torch.Tensor:
    if kernels.on_cpu(cts, q_neg, q_pos):
        return fold_round_plain(cts, q_neg, q_pos, t_gsw)
    two_m, n1, n2, _, d = cts.shape
    m2 = t_gsw * n1
    kernels.require(cts, (two_m, n1, n2, 2, d), "fold cts")
    kernels.require(q_neg, (n1, m2, 2, d), "fold q_neg")
    kernels.require(q_pos, (n1, m2, 2, d), "fold q_pos")
    if n1 != 3 or two_m % 2 or d not in kernels.REG_NTT_DEGREES:
        raise ValueError(f"fold kernel takes n1 = 3, an even ct count and "
                         f"d in {kernels.REG_NTT_DEGREES}; got "
                         f"{tuple(cts.shape)}")
    out = torch.empty((two_m // 2, n1, n2, 2, d), dtype=torch.int32,
                      device=cts.device)
    kernels.check(kernels.lib().spiral_fold_round(
        cts.data_ptr(), q_neg.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        ntt.kernel_table(d, cts.device).data_ptr(), two_m // 2, n1, n2,
        t_gsw, d, kernels.stream()), "spiral_fold_round")
    kernels.LAUNCHES["fold"] += 1
    return out


# limbs of the mxu contraction: JAX's splits residues < 2^28 into four
# 7-bit limbs (kernel K8b-2 32-bit words into four 8-bit limbs)
LIMB_BITS, N_LIMBS = 7, 4
# A round runs K8b (fold_round_mxu) where its m_out * n2 reaches
# MXU_MIN_COLS[t_gsw] and K8b-1 and K8b-2 take its shape (mxu_takes),
# else K3.  On an H100 a K8b round beat K3 by more than both engines'
# spread in every run at t_gsw 11 with m_out 128 to 1,024 (n2 2).  At
# t_gsw 8 and 9 with m_out 64 and t_gsw 11 with m_out 64 and 32 it was
# faster on average, but not by more than its own spread in every run:
# its three launches take the host about as long as the card takes for
# them, and K3's one does not (PERF.md).  A t_gsw not listed was not
# measured and runs K3.  Tests and chip_smoke.py set
# collections.defaultdict(int) to run K8b wherever it takes the shape,
# {} for K3 in every round.
MXU_MIN_COLS = {11: 256}

# K8b-2's limits and shared memory, as csrc/fold_mxu.cu computes them
# (its Geometry; tests/test_torch_kernels.py holds contract_smem to the
# kernel's spiral_fold_contract_smem on the card): slots a block, columns
# a tile, ring stages at most, padded epilogue and query rows, the shared
# memory a block may take, and the k steps its two instances hold.
ZG, NT, MAX_STAGES, OS_LD, QP_LD = 32, 8, 4, 33, 33
SMEM_MAX = 226 * 1024
KS_SMALL, KS_LARGE = 7, 9


def contract_geometry(n1: int, t_gsw: int) -> dict:
    """K8b-2's block in bytes: a ring of `stages` column tiles (E rows of
    8 columns x 128 B), two epilogue buffers, each k step's B row offsets
    and 1 KB of alignment slack; the prescaled query words (`qp`) fill
    stages 1 .. stages - 1 before their first loads."""
    E = 2 * t_gsw * n1
    ksteps = (E + 7) // 8
    stage = E * NT * ZG * 4
    os_bytes = 2 * n1 * NT * OS_LD * 4
    fixed = os_bytes + ksteps * 2 * 32 * 4 + 1024
    stages = min((SMEM_MAX - fixed) // stage, MAX_STAGES)
    return dict(E=E, ksteps=ksteps, stage=stage, os=os_bytes,
                qp=E * n1 * QP_LD * 16, stages=stages,
                total=stages * stage + fixed)


def contract_smem(n1: int, t_gsw: int) -> int:
    """K8b-2's dynamic shared memory in bytes; 0 for a shape it does not
    take (n1 outside 1-4, more k steps than its instances hold, or no
    room for a ring of 2 and the prescaled query)."""
    if not 1 <= n1 <= 4 or t_gsw < 2:
        return 0
    g = contract_geometry(n1, t_gsw)
    fits = g["ksteps"] <= KS_LARGE and g["stages"] >= 2 and \
        g["qp"] <= (g["stages"] - 1) * g["stage"]
    return g["total"] if fits else 0


def mxu_takes(n1: int, n2: int, t_gsw: int) -> bool:
    """Whether K8b-1 and K8b-2 take a fold round of n1 x n2 polys at t_gsw
    (their wrappers raise otherwise).  Both take the degrees K3 takes
    (kernels.REG_NTT_DEGREES), so the degree does not choose between
    them."""
    return 2 <= t_gsw <= 56 and n2 in (1, 2, 4, 8) and \
        contract_smem(n1, t_gsw) > 0


def fold_ntt_plain(cts_pairs: torch.Tensor, t_gsw: int) -> torch.Tensor:
    """cts_pairs (m_out, 2, n1, n2, 2, d) coeff -> G (2 li, 2 s, t_gsw,
    m_out, n1*n2, d) NTT: G[li, s, k, mo, jn1*n2 + c] = NTT(digit k of
    cts_pairs[mo, s, jn1, c]) (the JAX _fold_ntt_call's layout)."""
    m_out, _, n1, n2, _, d = cts_pairs.shape
    g = ntt.forward_plain(gadget_invert_signed_raw(cts_pairs, t_gsw, n1))
    return g.reshape(m_out, 2, t_gsw, n1, n2, 2, d).permute(
        5, 1, 2, 0, 3, 4, 6).reshape(2, 2, t_gsw, m_out, n1 * n2, d)


def fold_ntt(cts_pairs: torch.Tensor, t_gsw: int,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """fold_ntt_plain on the card.  `out`, a flat int32 CUDA tensor (the
    server's mxu_workspace), takes G when it holds G's size; else G is
    allocated here."""
    if kernels.on_cpu(cts_pairs):
        return fold_ntt_plain(cts_pairs, t_gsw)
    m_out, _, n1, n2, _, d = cts_pairs.shape
    kernels.require(cts_pairs, (m_out, 2, n1, n2, 2, d), "fold_ntt cts")
    if d not in kernels.REG_NTT_DEGREES or not 2 <= t_gsw <= 56:
        raise ValueError(f"fold_ntt kernel takes d in "
                         f"{kernels.REG_NTT_DEGREES} and 2 <= t_gsw <= 56; "
                         f"got {tuple(cts_pairs.shape)}, t_gsw {t_gsw}")
    shape = (2, 2, t_gsw, m_out, n1 * n2, d)
    if out is not None and out.numel() >= g_words(*shape[2:]):
        G = out[:g_words(*shape[2:])].view(shape)
        kernels.require(G, shape, "fold_ntt out")
    else:
        G = torch.empty(shape, dtype=torch.int32, device=cts_pairs.device)
    kernels.check(kernels.lib().spiral_fold_ntt(
        cts_pairs.data_ptr(), G.data_ptr(),
        ntt.kernel_table(d, cts_pairs.device).data_ptr(), m_out, n1, n2,
        t_gsw, d, kernels.stream()), "spiral_fold_ntt")
    kernels.LAUNCHES["fold_ntt"] += 1
    return G


def _limbs(x: torch.Tensor, bits: int) -> list:
    return [(x >> (bits * j)) & ((1 << bits) - 1) for j in range(N_LIMBS)]


@lru_cache(maxsize=None)
def _limb_scales(bits: int, device) -> torch.Tensor:
    """2^{bits j} mod each modulus, (N_LIMBS, 2) int64 on `device`: made
    once per (bits, device), so that no call copies it to the card."""
    return torch.tensor([[(1 << (bits * j)) % m for m in MODS]
                         for j in range(N_LIMBS)], device=device)


def fold_contract_limb_sums(G: torch.Tensor, q_neg: torch.Tensor,
                            q_pos: torch.Tensor, t_gsw: int,
                            bits: int = LIMB_BITS) -> torch.Tensor:
    """The contraction's int32 partial sums, in int64: G (2 li, 2 s, t_gsw,
    m_out, n1*n2, d) and q_neg/q_pos (n1, t_gsw*n1, 2, d) NTT -> o (4 i,
    2 li, m_out, n1 r, n2 c, d) with
        o[i] = sum_{s, k, jn1, j} limb_i((2^{bits j} q_s[r, k*n1 + jn1]) mod p)
                                  * limb_j(G[s, k, mo, jn1*n2 + c]),
    limbs of `bits` bits: 7, JAX's _fold_qpre prescale and
    _fold_contract_mxu sums (every term at most 127^2), or 8, kernel
    K8b-2's (at most 255^2, G's words as stored).  There are 2*t_gsw*n1*4
    terms."""
    _, _, _, m_out, P, d = G.shape
    n1 = q_neg.shape[0]
    n2 = P // n1
    p = p_col(G.device)                                       # (li, 1)
    q = torch.stack([q_neg, q_pos]).long().reshape(2, n1, t_gsw, n1, 2, d)
    # (j, s, r, k, jn1, li, d): (2^{bits j} q) mod p, then its i-limbs
    pw = _limb_scales(bits, G.device)
    qj = q[None] * pw[:, None, None, None, None, :, None] % p
    qi = torch.stack(_limbs(qj, bits))            # (i, j, s, r, k, jn1, li, d)
    G7 = G.reshape(2, 2, t_gsw, m_out, n1, n2, d)
    o = torch.zeros((N_LIMBS, 2, m_out, n1, n2, d), dtype=torch.int64,
                    device=G.device)
    for s in range(2):
        for k in range(t_gsw):
            for jn1 in range(n1):
                gl = _limbs(G7[:, s, k, :, jn1].long(), bits)  # j: li mo c d
                for j in range(N_LIMBS):
                    a = qi[:, j, s, :, k, jn1].permute(0, 2, 1, 3)  # i li r d
                    o += a[:, :, None, :, None] * gl[j][None, :, :, None]
    return o


def fold_contract_recombined(o: torch.Tensor, bits: int) -> torch.Tensor:
    """sum_i 2^{bits i} o[i] of fold_contract_limb_sums, before the
    reduction (below 2^44 at 7 bits, 2^49 at 8 at t_gsw <= 12)."""
    return sum(o[i] << (bits * i) for i in range(N_LIMBS))


def fold_contract_plain(G: torch.Tensor, q_neg: torch.Tensor,
                        q_pos: torch.Tensor, t_gsw: int) -> torch.Tensor:
    """-> (m_out, n1, n2, 2, d) NTT: the 7-bit limb sums recombined mod p,
    as _fold_contract_mxu does."""
    o = fold_contract_limb_sums(G, q_neg, q_pos, t_gsw)
    p = p_col(G.device)[:, :, None, None, None]                 # li ...
    v = fold_contract_recombined(o, LIMB_BITS) % p       # (li, mo, r, c, d)
    return v.permute(1, 2, 3, 0, 4).to(torch.int32)


def fold_contract(G: torch.Tensor, q_neg: torch.Tensor, q_pos: torch.Tensor,
                  t_gsw: int) -> torch.Tensor:
    if kernels.on_cpu(G, q_neg, q_pos):
        return fold_contract_plain(G, q_neg, q_pos, t_gsw)
    _, _, _, m_out, P, d = G.shape
    n1 = q_neg.shape[0]
    kernels.require(G, (2, 2, t_gsw, m_out, P, d), "fold_contract G")
    kernels.require(q_neg, (n1, t_gsw * n1, 2, d), "fold_contract q_neg")
    kernels.require(q_pos, (n1, t_gsw * n1, 2, d), "fold_contract q_pos")
    lib = kernels.lib()
    if P % n1 or d % 32 or P // n1 not in (1, 2, 4, 8) or \
            not lib.spiral_fold_contract_smem(n1, t_gsw):
        raise ValueError(f"fold_contract kernel takes n1 <= 4 rows, n2 in "
                         f"(1, 2, 4, 8), d a multiple of 32 and 2 * t_gsw * "
                         f"n1 <= 72; got G {tuple(G.shape)}, n1 {n1}, t_gsw "
                         f"{t_gsw}")
    out = torch.empty((m_out, n1, P // n1, 2, d), dtype=torch.int32,
                      device=G.device)
    kernels.check(lib.spiral_fold_contract(
        G.data_ptr(), q_neg.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        m_out, n1, P // n1, t_gsw, d, kernels.stream()),
        "spiral_fold_contract")
    kernels.LAUNCHES["fold_contract"] += 1
    return out


def fold_round_mxu(cts: torch.Tensor, q_neg: torch.Tensor,
                   q_pos: torch.Tensor, t_gsw: int,
                   g_buf: torch.Tensor | None = None) -> torch.Tensor:
    """fold_round through fold_ntt (G written into g_buf when it is large
    enough), fold_contract and the inverse NTT (a round of JAX
    fold_pallas.py fold_rounds_mxu); the same output."""
    G = fold_ntt(cts.unflatten(0, (-1, 2)).contiguous(), t_gsw, g_buf)
    return ntt.inverse(fold_contract(G, q_neg, q_pos, t_gsw))


def g_words(t_gsw: int, m_out: int, P: int, d: int) -> int:
    """The words of a K8b round's G (2 li, 2 s, t_gsw, m_out, P, d)."""
    return 4 * t_gsw * m_out * P * d


def round_uses_mxu(m_out: int, n1: int, n2: int, t_gsw: int) -> bool:
    """Whether a round with m_out output cts of n1 x n2 polys runs K8b
    (MXU_MIN_COLS, mxu_takes)."""
    try:
        least = MXU_MIN_COLS[t_gsw]     # a defaultdict answers any t_gsw
    except KeyError:
        return False
    return m_out * n2 >= least and mxu_takes(n1, n2, t_gsw)


def mxu_workspace(params: Params, device) -> torch.Tensor | None:
    """Storage for the G of every K8b round of a single query's fold, made
    once by its server so that no query allocates G (2.2 GB at
    spiral_24_256's round 1): as many int32 words as the largest round
    that round_uses_mxu picks needs, on a CUDA device; None on the CPU,
    whose plain fold_ntt makes its own, or where no round runs K8b."""
    p = params
    words = [g_words(p.t_gsw, p.num_per >> (r + 1), p.n1 * p.n2,
                     p.poly_len) for r in range(p.nu_2)
             if round_uses_mxu(p.num_per >> (r + 1), p.n1, p.n2, p.t_gsw)]
    if not words or torch.device(device).type != "cuda":
        return None
    return torch.empty(max(words), dtype=torch.int32, device=device)


def fold_rounds(cts_coeff: torch.Tensor, q_pos: torch.Tensor,
                q_neg: torch.Tensor, params: Params, start_round: int = 0,
                num_rounds: int | None = None,
                g_buf: torch.Tensor | None = None) -> torch.Tensor:
    """Run `num_rounds` rounds (all remaining if None) from global round
    `start_round`, which selects the q_pos/q_neg slot.  cts_coeff
    (m, n1, n2, 2, d) coeff; q_pos/q_neg (nu_2, n1, m2, 2, d) NTT.  Each
    round is K3 or, where round_uses_mxu, K8b (its G in g_buf, the
    server's mxu_workspace, where that is large enough): the same
    output."""
    rounds = cts_coeff.shape[0].bit_length() - 1
    rounds = rounds if num_rounds is None else num_rounds
    for r in range(start_round, start_round + rounds):
        two_m, n1, n2 = cts_coeff.shape[:3]
        args = (cts_coeff.contiguous(), q_neg[r].contiguous(),
                q_pos[r].contiguous(), params.t_gsw)
        cts_coeff = fold_round_mxu(*args, g_buf) \
            if round_uses_mxu(two_m // 2, n1, n2, params.t_gsw) \
            else fold_round(*args)
    return cts_coeff


def fold_ciphertexts(cts_coeff, q_pos, q_neg, params: Params,
                     start_round: int = 0,
                     g_buf: torch.Tensor | None = None) -> torch.Tensor:
    """Fold down to the single survivor (n1, n2, 2, d), coeff domain."""
    return fold_rounds(cts_coeff, q_pos, q_neg, params,
                       start_round=start_round, g_buf=g_buf)[0]


def fold_pack_round_plain(cts: torch.Tensor, q_neg: torch.Tensor,
                          q_pos: torch.Tensor, t_gsw: int) -> torch.Tensor:
    """cts ([B,] T, 2m, 2, 1, 2, d) coeff; q_neg/q_pos ([B,] 2, 2*t_gsw, 2,
    d) NTT -> ([B,] T, m, 2, 1, 2, d) coeff.  Unsigned digits, row k*2 + j
    holding digit k of ct row j (spiral_tpu/pack.py fold_pack_rounds)."""
    even, odd = _even_odd(cts)
    g_even = ntt.forward_plain(gadget_invert_raw(even, 2 * t_gsw, 2))
    g_odd = ntt.forward_plain(gadget_invert_raw(odd, 2 * t_gsw, 2))
    # q broadcasts over the trial and ct axes
    q_neg, q_pos = (q.unsqueeze(-5).unsqueeze(-5) for q in (q_neg, q_pos))
    return ntt.inverse_plain(add_raw(matmul_raw(q_neg, g_even),
                                     matmul_raw(q_pos, g_odd)))


def fold_pack_round(cts: torch.Tensor, q_neg: torch.Tensor,
                    q_pos: torch.Tensor, t_gsw: int) -> torch.Tensor:
    if kernels.on_cpu(cts, q_neg, q_pos):
        return fold_pack_round_plain(cts, q_neg, q_pos, t_gsw)
    T, two_m, _, _, _, d = cts.shape
    kernels.require(cts, (T, two_m, 2, 1, 2, d), "fold_pack cts")
    kernels.require(q_neg, (2, 2 * t_gsw, 2, d), "fold_pack q_neg")
    kernels.require(q_pos, (2, 2 * t_gsw, 2, d), "fold_pack q_pos")
    if two_m % 2 or d not in kernels.REG_NTT_DEGREES or \
            not 2 <= t_gsw <= 56:
        raise ValueError(f"fold_pack kernel takes an even ct count, d in "
                         f"{kernels.REG_NTT_DEGREES} and 2 <= t_gsw <= 56; "
                         f"got {tuple(cts.shape)}, t_gsw {t_gsw}")
    # pairs (2o, 2o+1) never cross a trial, so the trial axis flattens
    # into the output-ct index
    out = torch.empty((T, two_m // 2, 2, 1, 2, d), dtype=torch.int32,
                      device=cts.device)
    kernels.check(kernels.lib().spiral_fold_pack_round(
        cts.data_ptr(), q_neg.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        ntt.kernel_table(d, cts.device).data_ptr(), T * two_m // 2, t_gsw,
        d, kernels.stream()), "spiral_fold_pack_round")
    kernels.LAUNCHES["fold_pack"] += 1
    return out


def fold_pack_rounds(cts_coeff: torch.Tensor, q_pos: torch.Tensor,
                     q_neg: torch.Tensor, params: Params) -> torch.Tensor:
    """cts_coeff (T, m, 2, 1, 2, d) coeff; q_pos/q_neg (nu_2, 2, 2*t_gsw,
    2, d) NTT.  Folds each trial down to its survivor: (T, 1, 2, 1, 2, d)."""
    for r in range(cts_coeff.shape[1].bit_length() - 1):
        cts_coeff = fold_pack_round(cts_coeff.contiguous(),
                                    q_neg[r].contiguous(),
                                    q_pos[r].contiguous(), params.t_gsw)
    return cts_coeff


def _check_fold_shapes(cts, q_neg, q_pos, ct_shape, q_shape, t_gsw, name):
    kernels.require(cts, ct_shape, f"{name} cts")
    kernels.require(q_neg, q_shape, f"{name} q_neg")
    kernels.require(q_pos, q_shape, f"{name} q_pos")
    d = ct_shape[-1]
    if d not in kernels.REG_NTT_DEGREES or not 2 <= t_gsw <= 56:
        raise ValueError(f"{name} kernel takes d in "
                         f"{kernels.REG_NTT_DEGREES} and 2 <= t_gsw <= 56; "
                         f"got {ct_shape}, t_gsw {t_gsw}")


def fold_round_batch(cts: torch.Tensor, q_neg: torch.Tensor,
                     q_pos: torch.Tensor, t_gsw: int) -> torch.Tensor:
    """cts (B, 2m, 3, n2, 2, d) coeff; q_neg/q_pos (B, 3, 3*t_gsw, 2, d) NTT
    -> (B, m, 3, n2, 2, d) coeff: one launch of K5 for the batch."""
    if kernels.on_cpu(cts, q_neg, q_pos):
        return fold_round_plain(cts, q_neg, q_pos, t_gsw)
    B, two_m, n1, n2, _, d = cts.shape
    if n1 != 3 or two_m % 2:
        raise ValueError(f"fold_batch kernel takes n1 = 3 and an even ct "
                         f"count; got {tuple(cts.shape)}")
    _check_fold_shapes(cts, q_neg, q_pos, (B, two_m, n1, n2, 2, d),
                       (B, n1, t_gsw * n1, 2, d), t_gsw, "fold_batch")
    out = torch.empty((B, two_m // 2, n1, n2, 2, d), dtype=torch.int32,
                      device=cts.device)
    kernels.check(kernels.lib().spiral_fold_round_batch(
        cts.data_ptr(), q_neg.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        ntt.kernel_table(d, cts.device).data_ptr(), B, two_m // 2, n1, n2,
        t_gsw, d, kernels.stream()), "spiral_fold_round_batch")
    kernels.LAUNCHES["fold_batch"] += 1
    return out


def fold_rounds_batch(cts_b: torch.Tensor, q_pos_b: torch.Tensor,
                      q_neg_b: torch.Tensor, params: Params,
                      start_round: int = 0,
                      num_rounds: int | None = None) -> torch.Tensor:
    """fold_rounds over a batch: cts_b (B, m, n1, n2, 2, d) coeff,
    q_pos_b/q_neg_b (B, nu_2, n1, m2, 2, d) NTT; `num_rounds` rounds (all
    remaining if None) from global round `start_round`, each query folded
    against its own q -> (B, m / 2^rounds, n1, n2, 2, d), the (B, 1, n1,
    n2, 2, d) survivors when every round runs."""
    rounds = cts_b.shape[1].bit_length() - 1
    rounds = rounds if num_rounds is None else num_rounds
    for r in range(start_round, start_round + rounds):
        cts_b = fold_round_batch(cts_b.contiguous(),
                                 q_neg_b[:, r].contiguous(),
                                 q_pos_b[:, r].contiguous(), params.t_gsw)
    return cts_b


def fold_pack_round_batch(cts: torch.Tensor, q_neg: torch.Tensor,
                          q_pos: torch.Tensor, t_gsw: int) -> torch.Tensor:
    """cts (B, T, 2m, 2, 1, 2, d) coeff; q_neg/q_pos (B, 2, 2*t_gsw, 2, d)
    NTT -> (B, T, m, 2, 1, 2, d) coeff: one launch of K5 for the batch."""
    if kernels.on_cpu(cts, q_neg, q_pos):
        return fold_pack_round_plain(cts, q_neg, q_pos, t_gsw)
    B, T, two_m, _, _, _, d = cts.shape
    if two_m % 2:
        raise ValueError(f"fold_pack_batch kernel takes an even ct count; "
                         f"got {tuple(cts.shape)}")
    _check_fold_shapes(cts, q_neg, q_pos, (B, T, two_m, 2, 1, 2, d),
                       (B, 2, 2 * t_gsw, 2, d), t_gsw, "fold_pack_batch")
    out = torch.empty((B, T, two_m // 2, 2, 1, 2, d), dtype=torch.int32,
                      device=cts.device)
    kernels.check(kernels.lib().spiral_fold_pack_round_batch(
        cts.data_ptr(), q_neg.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        ntt.kernel_table(d, cts.device).data_ptr(), B, T * two_m // 2, t_gsw,
        d, kernels.stream()), "spiral_fold_pack_round_batch")
    kernels.LAUNCHES["fold_pack_batch"] += 1
    return out


def fold_pack_rounds_batch(cts_b: torch.Tensor, q_pos_b: torch.Tensor,
                           q_neg_b: torch.Tensor,
                           params: Params) -> torch.Tensor:
    """fold_pack_rounds over a batch: cts_b (B, T, m, 2, 1, 2, d) coeff,
    q_pos_b/q_neg_b (B, nu_2, 2, 2*t_gsw, 2, d) NTT -> (B, T, 1, 2, 1, 2,
    d)."""
    for r in range(cts_b.shape[2].bit_length() - 1):
        cts_b = fold_pack_round_batch(cts_b.contiguous(),
                                      q_neg_b[:, r].contiguous(),
                                      q_pos_b[:, r].contiguous(),
                                      params.t_gsw)
    return cts_b
