"""K8a and K8b on the CPU: their plain versions against the JAX package's
SPIRAL_AUTO=matmul and SPIRAL_FOLD=mxu paths (Pallas in interpret mode)
on the same numpy-seeded inputs, the limb contraction against the exact
one, and the fold's choice of K3 or K8b per round.  Each package
forwards the same coefficient-domain polys with its own NTT engine (the
slot orders differ) and the outputs compare in the coefficient domain.
All arithmetic is exact: the tolerance is 0."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiral_tpu.arith.ntt_pallas import crt_ntt_pallas
from spiral_tpu.params import B_I, P_I, Params
from spiral_tpu.server import expand_pallas
from spiral_tpu.server.fold_pallas import fold_rounds_mxu
from spiral_tpu_torch import interop
from spiral_tpu_torch import params as tparams
from spiral_tpu_torch.arith import ntt
from spiral_tpu_torch.core.poly import add_raw, automorph_raw, matmul_raw
from spiral_tpu_torch.server import expand, fold

D = 2048     # the JAX Pallas NTT tables fix d


def _residues(rng, shape):
    return np.stack([rng.integers(0, P_I, shape), rng.integers(0, B_I, shape)],
                    axis=-2).astype(np.uint32)


def _t(a):
    return interop.to_torch(a, "cpu")


def _eq(got, want):
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("t", [2049, 513, 9])
def test_inv_ntt_automorph_matches_jax(monkeypatch, t):
    """K8a's plain version equals JAX _auto_call: round 0 (t = d + 1), a
    middle round and round 8 of spiral_20_256."""
    monkeypatch.setenv("SPIRAL_AUTO", "matmul")
    x = _residues(np.random.default_rng(t), (2, 2, 1, D))   # (N, 2, 1, 2, d)
    want = expand_pallas.inv_ntt_automorph(
        crt_ntt_pallas(D).forward(jnp.asarray(x)), t, interpret=True)
    got = expand.inv_ntt_automorph(ntt.forward_plain(_t(x)), t)
    _eq(got, want)
    _eq(got, interop.to_numpy(automorph_raw(_t(x), t)))


def _fold_case(t_gsw, nu_2, seed):
    """(JAX params, port params, cts, JAX q_pos/q_neg, port q_pos/q_neg):
    the same coefficient-domain queries, each forwarded by its own NTT."""
    kw = dict(nu_1=2, nu_2=nu_2, p_db=256, t_gsw=t_gsw, t_conv=4, t_exp=8,
              t_exp_right=8)
    p, tp = Params(**kw), tparams.Params(**kw)
    rng = np.random.default_rng(seed)
    cts = _residues(rng, (1 << nu_2, p.n1, p.n2, D))
    qs = [_residues(rng, (nu_2, p.n1, p.m2, D)) for _ in range(2)]
    pe = crt_ntt_pallas(D)
    return (p, tp, cts, [pe.forward(jnp.asarray(q)) for q in qs],
            [ntt.forward_plain(_t(q)) for q in qs])


@pytest.fixture
def mxu_every_round(monkeypatch):
    monkeypatch.setattr(fold, "MXU_MAX_K3_BLOCKS", 1 << 30)


@pytest.mark.parametrize("t_gsw, nu_2", [(3, 2), (9, 3)])
def test_fold_mxu_matches_jax(mxu_every_round, t_gsw, nu_2):
    """fold_rounds with K8b in every round equals JAX fold_rounds_mxu: u32
    digits at t_gsw 3, the 7-bit digits of spiral_20_256 at 9."""
    p, tp, cts, (jqp, jqn), (qp, qn) = _fold_case(t_gsw, nu_2, 7 + t_gsw)
    want = fold_rounds_mxu(jnp.asarray(cts), jqp, jqn, p, interpret=True)
    _eq(fold.fold_rounds(_t(cts), qp, qn, tp), want)


def test_fold_mxu_partial_rounds_match_jax(mxu_every_round):
    """Two rounds, then the rest from start_round = 2 (the sharded split)."""
    p, tp, cts, (jqp, jqn), (qp, qn) = _fold_case(3, 3, 11)
    want = fold_rounds_mxu(jnp.asarray(cts), jqp, jqn, p, 0, 2,
                           interpret=True)
    half = fold.fold_rounds(_t(cts), qp, qn, tp, 0, 2)
    _eq(half, want)
    _eq(fold.fold_ciphertexts(half, qp, qn, tp, start_round=2),
        fold_rounds_mxu(want, jqp, jqn, p, start_round=2,
                        interpret=True)[0])


@pytest.mark.parametrize("t_gsw", [8, 9, 11])
def test_fold_contract_limbs_exact(t_gsw):
    """The 7-bit limb contraction equals the exact NTT-domain contraction on
    random residues, and its int32 partial sums stay below 2^31."""
    n1, n2, m_out, d = 3, 2, 3, 256
    rng = np.random.default_rng(100 + t_gsw)
    G = _t(np.moveaxis(_residues(rng, (2, t_gsw, m_out, n1 * n2, d)), -2, 0)
           .copy())                               # (2 li, 2 s, t, mo, P, d)
    qn, qp = (_t(_residues(rng, (n1, t_gsw * n1, d))) for _ in range(2))
    # q_s[r, k*n1 + jn1] * G[s, k, mo, jn1*n2 + c], summed over (k, jn1)
    Gs = G.reshape(2, 2, t_gsw, m_out, n1, n2, d).permute(
        1, 3, 2, 4, 5, 0, 6).reshape(2, m_out, t_gsw * n1, n2, 2, d)
    want = add_raw(matmul_raw(qn, Gs[0]), matmul_raw(qp, Gs[1]))
    assert torch.equal(fold.fold_contract_plain(G, qn, qp, t_gsw), want)
    sums = fold.fold_contract_limb_sums(G, qn, qp, t_gsw)
    terms = 2 * t_gsw * n1 * fold.N_LIMBS
    assert int(sums.max()) <= terms * 127 ** 2 < 2 ** 31
    assert int(sums.min()) >= 0


def test_fold_ntt_plain_layout():
    """G[li, s, k, mo, jn1*n2 + c] is the NTT of digit k of pair member s of
    ct pair mo, row jn1 and column c: the rows fold_round_plain contracts."""
    n1, n2, t_gsw, d = 3, 2, 9, 256
    cts = _t(_residues(np.random.default_rng(5), (4, n1, n2, d)))
    G = fold.fold_ntt_plain(cts.unflatten(0, (-1, 2)), t_gsw)
    assert G.shape == (2, 2, t_gsw, 2, n1 * n2, d)
    from spiral_tpu_torch.core.gadget import gadget_invert_signed_raw
    dig = ntt.forward_plain(gadget_invert_signed_raw(cts[3], t_gsw, n1))
    # ct 3 is member s = 1 of pair 1; its digit row k*n1 + jn1
    for k, jn1, c in ((0, 0, 0), (4, 2, 1), (8, 1, 0)):
        assert torch.equal(G[:, 1, k, 1, jn1 * n2 + c],
                           dig[k * n1 + jn1, c])


def test_fold_picks_engine_per_round(monkeypatch):
    """A round runs K8b when K3 would run at most MXU_MAX_K3_BLOCKS blocks
    (2 * m_out * n2), else K3; either way the fold's output is K3's.  By
    default no round of the headline presets runs K8b: the clustered K3
    beat it in every round measured on the card."""
    for name in ("spiral_20_256", "spiral_24_256"):
        pr = tparams.preset(name)
        assert not any(fold.round_uses_mxu(pr.num_per >> (r + 1), pr.n2)
                       for r in range(pr.nu_2)), name
    tp = tparams.Params(nu_1=2, nu_2=3, p_db=256, t_gsw=3, t_conv=4,
                        t_exp=8, t_exp_right=8, poly_len=256)
    rng = np.random.default_rng(12)
    cts = _t(_residues(rng, (8, tp.n1, tp.n2, 256)))
    qp, qn = (_t(_residues(rng, (3, tp.n1, tp.m2, 256))) for _ in range(2))
    want = fold.fold_rounds(cts, qp, qn, tp)
    for name in ("fold_round", "fold_round_mxu"):
        monkeypatch.setattr(fold, name, lambda *a, f=getattr(fold, name),
                            name=name: (calls.append(name), f(*a))[1])
    for limit, engines in ((0, ["fold_round"] * 3),
                           (8, ["fold_round"] + ["fold_round_mxu"] * 2),
                           (1 << 30, ["fold_round_mxu"] * 3)):
        monkeypatch.setattr(fold, "MXU_MAX_K3_BLOCKS", limit)
        calls = []
        assert torch.equal(fold.fold_rounds(cts, qp, qn, tp), want)
        assert calls == engines, limit
