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
"""
from __future__ import annotations

import torch

from ..params import Params
from .. import kernels
from ..arith import ntt
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
    if n1 != 3 or two_m % 2 or not 64 <= d <= 2048 or d & (d - 1):
        raise ValueError(f"fold kernel takes n1 = 3, an even ct count and "
                         f"64 <= d <= 2048; got {tuple(cts.shape)}")
    out = torch.empty((two_m // 2, n1, n2, 2, d), dtype=torch.int32,
                      device=cts.device)
    kernels.check(kernels.lib().spiral_fold_round(
        cts.data_ptr(), q_neg.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        ntt.kernel_table(d, cts.device).data_ptr(), two_m // 2, n1, n2,
        t_gsw, d, kernels.stream()), "spiral_fold_round")
    kernels.LAUNCHES["fold"] += 1
    return out


def fold_rounds(cts_coeff: torch.Tensor, q_pos: torch.Tensor,
                q_neg: torch.Tensor, params: Params, start_round: int = 0,
                num_rounds: int | None = None) -> torch.Tensor:
    """Run `num_rounds` rounds (all remaining if None) from global round
    `start_round`, which selects the q_pos/q_neg slot.  cts_coeff
    (m, n1, n2, 2, d) coeff; q_pos/q_neg (nu_2, n1, m2, 2, d) NTT."""
    rounds = cts_coeff.shape[0].bit_length() - 1
    rounds = rounds if num_rounds is None else num_rounds
    for r in range(start_round, start_round + rounds):
        cts_coeff = fold_round(cts_coeff.contiguous(), q_neg[r].contiguous(),
                               q_pos[r].contiguous(), params.t_gsw)
    return cts_coeff


def fold_ciphertexts(cts_coeff, q_pos, q_neg, params: Params,
                     start_round: int = 0) -> torch.Tensor:
    """Fold down to the single survivor (n1, n2, 2, d), coeff domain."""
    return fold_rounds(cts_coeff, q_pos, q_neg, params,
                       start_round=start_round)[0]


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
    if two_m % 2 or not 64 <= d <= 2048 or d & (d - 1) or \
            not 2 <= t_gsw <= 56:
        raise ValueError(f"fold_pack kernel takes an even ct count, "
                         f"64 <= d <= 2048 and 2 <= t_gsw <= 56; got "
                         f"{tuple(cts.shape)}, t_gsw {t_gsw}")
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
    if not 64 <= d <= 2048 or d & (d - 1) or not 2 <= t_gsw <= 56:
        raise ValueError(f"{name} kernel takes 64 <= d <= 2048 and "
                         f"2 <= t_gsw <= 56; got {ct_shape}, t_gsw {t_gsw}")


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
                      q_neg_b: torch.Tensor, params: Params) -> torch.Tensor:
    """fold_rounds over a batch: cts_b (B, m, n1, n2, 2, d) coeff,
    q_pos_b/q_neg_b (B, nu_2, n1, m2, 2, d) NTT -> the (B, 1, n1, n2, 2, d)
    survivors, each query folded against its own q."""
    for r in range(cts_b.shape[1].bit_length() - 1):
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
