"""K8a and K8b on the CPU: their plain versions against the JAX package's
SPIRAL_AUTO=matmul and SPIRAL_FOLD=mxu paths (Pallas in interpret mode)
on the same numpy-seeded inputs, the limb contraction against the exact
one, and the fold's choice of K3 or K8b per round.  Each package
forwards the same coefficient-domain polys with its own NTT engine (the
slot orders differ) and the outputs compare in the coefficient domain.
All arithmetic is exact: the tolerance is 0."""
from collections import defaultdict

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
from spiral_tpu_torch import kernels
from spiral_tpu_torch.server import expand, fold
from spiral_tpu_torch.server.fold import (KS_LARGE, KS_SMALL, MAX_STAGES,
                                          NT, OS_LD, ZG)

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
    monkeypatch.setattr(fold, "MXU_MIN_COLS", defaultdict(int))


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


def _round_shapes(pr):
    """(m_out, n1, n2, t_gsw, d) of each round of a preset's single-query
    fold."""
    return [(pr.num_per >> (r + 1), pr.n1, pr.n2, pr.t_gsw, pr.poly_len)
            for r in range(pr.nu_2)]


def test_fold_picks_engine_per_round(monkeypatch):
    """A round runs K8b where m_out * n2 reaches MXU_MIN_COLS[t_gsw] and
    K8b takes its shape, else K3; either way the fold's output is K3's.
    By default only the rounds of t_gsw 11 where K8b beat K3 on the card
    in every run run K8b: m_out 128 and up (rounds 1-4 of spiral_24_256,
    1-2 of spiral_22_256); no round of spiral_20_256 (t_gsw 9), its t_gsw
    8 variant, or the t_gsw 12 and 13 presets, which were not measured."""
    for name, mxu_rounds in (("spiral_20_256", 0), ("spiral_20_256_paper", 0),
                             ("spiral_22_256", 2), ("spiral_24_256", 4),
                             ("spiral_26_256", 0), ("spiral_28_256", 0)):
        shapes = _round_shapes(tparams.preset(name))
        picks = [fold.round_uses_mxu(*s[:4]) for s in shapes]
        assert picks == [r < mxu_rounds for r in range(len(shapes))], name
    assert fold.mxu_workspace(tparams.preset("spiral_24_256"), "cpu") is None
    tp = tparams.Params(nu_1=2, nu_2=3, p_db=256, t_gsw=3, t_conv=4,
                        t_exp=8, t_exp_right=8, poly_len=256)
    rng = np.random.default_rng(12)
    cts = _t(_residues(rng, (8, tp.n1, tp.n2, 256)))
    qp, qn = (_t(_residues(rng, (3, tp.n1, tp.m2, 256))) for _ in range(2))
    want = fold.fold_rounds(cts, qp, qn, tp)
    for name in ("fold_round", "fold_round_mxu"):
        monkeypatch.setattr(fold, name, lambda *a, f=getattr(fold, name),
                            name=name: (calls.append(name), f(*a))[1])
    # rounds of m_out * n2 8, 4 and 2 (m_out 4, 2, 1; n2 2; t_gsw 3)
    for rule, engines in (({}, ["fold_round"] * 3),
                          ({3: 4}, ["fold_round_mxu"] * 2 + ["fold_round"]),
                          ({9: 0}, ["fold_round"] * 3),
                          (defaultdict(int), ["fold_round_mxu"] * 3)):
        monkeypatch.setattr(fold, "MXU_MIN_COLS", rule)
        calls = []
        assert torch.equal(fold.fold_rounds(cts, qp, qn, tp), want)
        assert calls == engines, rule


@pytest.mark.parametrize("rule", ["default", "k8b"])
def test_fold_rounds_go_to_a_kernel_that_takes_them(monkeypatch, rule):
    """Every round of every preset's single-query fold goes to a kernel
    whose wrapper takes its shape, under the default rule and with K8b
    wherever it fits: K8b only where K8b-2's block fits (2 t_gsw n1 <=
    72, its shared memory as the kernel computes it) and n2 is 1, 2, 4 or
    8, K3 (n1 = 3) elsewhere; both at d in kernels.REG_NTT_DEGREES.  So
    spiral_28_256's t_gsw 13 (78 elements) runs K3 even when K8b is
    forced."""
    if rule == "k8b":
        monkeypatch.setattr(fold, "MXU_MIN_COLS", defaultdict(int))
    for name, pr in tparams.PRESETS.items():
        for m_out, n1, n2, t, d in _round_shapes(pr):
            assert d in kernels.REG_NTT_DEGREES, name
            if fold.round_uses_mxu(m_out, n1, n2, t):
                assert 2 * t * n1 <= 8 * KS_LARGE and n2 in (1, 2, 4, 8)
                assert fold.contract_smem(n1, t) > 0, (name, t)
            else:
                assert n1 == 3, name
    forced = rule == "k8b"
    assert not any(fold.round_uses_mxu(*s[:4]) for s in _round_shapes(
        tparams.preset("spiral_28_256")))
    assert fold.round_uses_mxu(1024, 3, 2, 12) == forced
    assert not fold.contract_smem(3, 13) and not fold.contract_smem(5, 2)


# ---- K8b-2 (csrc/fold_mxu.cu): its limb scheme, shared memory and
# fragments, mirrored in numpy ----
WORDS = ["random", "worst"]


def _contract_operands(rng, words, t_gsw, n1=3, n2=2, m_out=3, d=64):
    """G (2 li, 2 s, t, m_out, n1*n2, d) and q_neg/q_pos (n1, t*n1, 2, d):
    random residues, or p - 1 everywhere (the largest limb products)."""
    if words == "worst":
        full = lambda shape: _residues(rng, shape) * 0 + np.array(
            [[P_I - 1], [B_I - 1]], dtype=np.uint32)
    else:
        full = lambda shape: _residues(rng, shape)
    G = np.moveaxis(full((2, t_gsw, m_out, n1 * n2, d)), -2, 0).copy()
    return _t(G), _t(full((n1, t_gsw * n1, d))), _t(full((n1, t_gsw * n1, d)))


def _exact_contract(G, qn, qp, t_gsw, n1):
    m_out, n2 = G.shape[3], G.shape[4] // n1
    d = G.shape[-1]
    Gs = G.reshape(2, 2, t_gsw, m_out, n1, n2, d).permute(
        1, 3, 2, 4, 5, 0, 6).reshape(2, m_out, t_gsw * n1, n2, 2, d)
    return add_raw(matmul_raw(qn, Gs[0]), matmul_raw(qp, Gs[1]))


@pytest.mark.parametrize("words", WORDS)
@pytest.mark.parametrize("bits", [7, 8])
@pytest.mark.parametrize("t_gsw", [8, 9, 11])
def test_fold_contract_limb_widths(t_gsw, bits, words):
    """JAX's 7-bit limbs and the kernel's 8-bit limbs (G's words as stored,
    the query prescaled) both give the exact contraction, on random
    residues and on p - 1 everywhere; the int32 sums stay below 2^31 (and
    the kernel's below 2^24.1) and the recombination below 2^64 (the
    kernel's below 2^49, one Barrett reduction)."""
    n1 = 3
    G, qn, qp = _contract_operands(np.random.default_rng(7 * t_gsw + bits),
                                   words, t_gsw)
    o = fold.fold_contract_limb_sums(G, qn, qp, t_gsw, bits)
    terms = 2 * t_gsw * n1 * fold.N_LIMBS
    assert int(o.min()) >= 0
    assert int(o.max()) <= terms * ((1 << bits) - 1) ** 2 < 2 ** 31
    v = fold.fold_contract_recombined(o, bits)
    assert 0 <= int(v.min()) and int(v.max()) < 2 ** 63
    if bits == 8:
        assert int(o.max()) < 2 ** 24.1 and int(v.max()) < 2 ** 49
    p = torch.tensor([P_I, B_I])[:, None, None, None, None]
    got = (v % p).permute(1, 2, 3, 0, 4).to(torch.int32)
    assert torch.equal(got, _exact_contract(G, qn, qp, t_gsw, n1))


# the card's shared memory a block may take (227 KB)
SMEM_CARD = 232448


def _b_row(e, col, n1, n2):
    """The stage row of element e = k' n1 + jn1 and tile column col =
    mo n2 + c: the TMA box (32 slots, n2, n1, 8 / n2, 2 t_gsw)."""
    kp, jn1 = e // n1, e % n1
    return ((kp * (NT // n2) + col // n2) * n1 + jn1) * n2 + col % n2


def _rof(n1, n2, E, ksteps):
    """Rof[kq, h, lane]: R*32 + 4 (R & 7) of lane (g, tig)'s element
    8 kq + tig + 4 h (clamped to E - 1) of column g."""
    lane = np.arange(32)
    out = np.empty((ksteps, 2, 32), dtype=np.int64)
    for kq in range(ksteps):
        for h in range(2):
            e = np.minimum(8 * kq + (lane & 3) + 4 * h, E - 1)
            R = _b_row(e, lane >> 2, n1, n2)
            out[kq, h] = R * ZG + ((R & 7) << 2)
    return out


@pytest.mark.parametrize("t_gsw", [8, 9, 11])
def test_contract_geometry_and_banks(t_gsw):
    """At t_gsw 8, 9 and 11 (n1 3, n2 2): a ring of at least 3 stages fits
    the card's 227 KB with the mbarriers; stages are whole 1 KB swizzle
    periods; the prescaled query fits stages 1 ..; an instance holds the k
    steps; each k step's B reads cover every (element, column) of the tile
    once, within the stage, at most 4 lanes a bank; the epilogue's writes
    hit 32 distinct banks; the grid's column ranges cover the tiles."""
    n1, n2 = 3, 2
    geo = fold.contract_geometry(n1, t_gsw)
    assert geo["stages"] >= 3 and geo["total"] + 8 * MAX_STAGES <= SMEM_CARD
    assert geo["stage"] % 1024 == 0
    assert geo["qp"] <= (geo["stages"] - 1) * geo["stage"]
    assert geo["ksteps"] <= (KS_SMALL if t_gsw <= 9 else KS_LARGE)
    E, rof = geo["E"], _rof(n1, n2, geo["E"], geo["ksteps"])
    lane = np.arange(32)
    seen = set()
    for kq in range(geo["ksteps"]):
        for h in range(2):
            e = 8 * kq + (lane & 3) + 4 * h
            R = rof[kq, h] // ZG
            assert (R < E * NT).all()
            seen |= {(int(a), int(b)) for a, b, ok in
                     zip(e, lane >> 2, e < E) if ok}
            for zl in range(ZG):
                banks = np.bincount((rof[kq, h] ^ zl) % 32)
                assert banks.max() <= 4
    assert seen == {(e, c) for e in range(E) for c in range(NT)}
    g, tig = lane >> 2, lane & 3
    for zl in range(ZG):       # rows r = g < n1 of lanes with g < 4
        for cc in range(2):
            ok = g < n1
            addr = ((g * NT + 2 * tig + cc) * OS_LD + zl)[ok]
            assert len(set(addr % 32)) == ok.sum()
    for d, m_out in ((2048, 64), (2048, 1), (2048, 1024), (256, 5)):
        groups, ntiles = 2 * d // ZG, (m_out * n2 + NT - 1) // NT
        chunks = max(1, min(132 // groups, ntiles))
        spans = [(c * ntiles // chunks, (c + 1) * ntiles // chunks)
                 for c in range(chunks)]
        assert [a for a, b in spans] == [0] + [b for a, b in spans][:-1]
        assert spans[-1][1] == ntiles and all(b > a for a, b in spans)


def _kernel_contract(G, qn, qp, t_gsw, n1, n2):
    """fold_contract_kernel in numpy, lane by lane: the TMA stage image of
    each column tile (128-byte swizzle, zeros past m_out), each warp's A
    fragments built from its slot's q words, B fragments read at Rof ^ zl,
    mma.sync.m16n8k32 as its fragment maps say, the epilogue's pairing of
    lane and lane ^ 16 and one reduction mod p."""
    G = G.numpy().astype(np.int64)
    qs = [q.numpy().astype(np.int64) for q in (qn, qp)]
    _, _, _, m_out, P, d = G.shape
    geo = fold.contract_geometry(n1, t_gsw)
    E, ks = geo["E"], geo["ksteps"]
    rof = _rof(n1, n2, E, ks)
    m2, mo_tile, N = t_gsw * n1, NT // n2, m_out * n2
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    out = np.zeros((m_out, n1, n2, 2, d), dtype=np.int64)
    Gb = G.reshape(2, 2 * t_gsw, m_out, n1, n2, d)   # li, k', mo, jn1, c
    for li, p in enumerate((P_I, B_I)):
        for z in range(d):
            zl = z % ZG
            # the prescaled words (W0, W2, W1, W3) of q row (s n1 + r) m2
            # + kk, W_i's byte j = limb_i(2^(8j) q mod p)
            qrow = np.concatenate([q[:, :, li, z].reshape(-1) for q in qs])
            Q = np.stack([qrow * ((1 << (8 * j)) % p) % p for j in range(4)])
            Wp = np.stack([sum(((Q[j] >> (8 * i)) & 0xFF) << (8 * j)
                               for j in range(4)) for i in (0, 2, 1, 3)])
            # A: (16 rows, 4 E' bytes) from the lanes' registers, each an
            # 8-byte read (W_ilo, W_ilo+2) of row r m2 + e + s (n1 - 1) m2
            A = np.zeros((16, 32 * ks), dtype=np.int64)
            r, ilo = g & 3, g >> 2
            for kq in range(ks):
                for hh in range(2):
                    e = 8 * kq + tig + 4 * hh
                    for ln in range(32):
                        if r[ln] >= n1 or e[ln] >= E:
                            continue
                        s = int(e[ln] >= m2)
                        row = r[ln] * m2 + e[ln] + s * (n1 - 1) * m2
                        w = Wp[2 * ilo[ln]:2 * ilo[ln] + 2, row]
                        col = 32 * kq + 4 * (tig[ln] + 4 * hh)
                        for h1 in range(2):      # register 2 hh + h1
                            for j in range(4):
                                A[g[ln] + 8 * h1, col + j] = \
                                    (int(w[h1]) >> (8 * j)) & 0xFF
            assert int(A[[3, 7, 11, 15]].max()) == 0     # r = 3: padding
            for nt in range((N + NT - 1) // NT):
                img = np.zeros(E * NT * ZG, dtype=np.int64)
                for kp in range(2 * t_gsw):
                    for mo in range(mo_tile):
                        mg = nt * mo_tile + mo
                        for jn1 in range(n1):
                            for c in range(n2):
                                R = ((kp * mo_tile + mo) * n1 + jn1) * n2 + c
                                if mg < m_out:
                                    w0 = z - zl
                                    img[R * ZG + (np.arange(ZG) ^
                                                  ((R & 7) << 2))] = \
                                        Gb[li, kp, mg, jn1, c, w0:w0 + ZG]
                Bm = np.zeros((32 * ks, NT), dtype=np.int64)
                for kq in range(ks):
                    for h in range(2):
                        word = img[rof[kq, h] ^ zl]
                        for j in range(4):
                            Bm[32 * kq + 16 * h + 4 * tig + j, g] = \
                                (word >> (8 * j)) & 0xFF
                D = A @ Bm
                assert D.max() < 2 ** 31
                acc = np.stack([D[g, 2 * tig], D[g, 2 * tig + 1],
                                D[g + 8, 2 * tig], D[g + 8, 2 * tig + 1]])
                ilo = g >> 2
                for cc in range(2):
                    v = (acc[cc] << (8 * ilo)) + \
                        (acc[2 + cc] << (8 * (ilo + 2)))
                    v = v + v[lane ^ 16]
                    assert v.max() < 2 ** 49
                    for ln in np.nonzero((ilo == 0) & (g < n1))[0]:
                        n = nt * NT + 2 * tig[ln] + cc
                        if n < N:
                            out[n // n2, g[ln], n % n2, li, z] = v[ln] % p
    return torch.from_numpy(out.astype(np.int32))


@pytest.mark.parametrize("words", WORDS)
@pytest.mark.parametrize("t_gsw, m_out", [(9, 5), (11, 1), (3, 2)])
def test_contract_kernel_model(t_gsw, m_out, words):
    """The numpy model of K8b-2's fragments equals fold_contract_plain: t_gsw
    9 (7 k steps, the last part zeros) over a ragged second column tile,
    t_gsw 11 (9 k steps) at m_out 1, t_gsw 3 (2 k steps)."""
    n1, n2, d = 3, 2, 64
    G, qn, qp = _contract_operands(np.random.default_rng(40 + t_gsw), words,
                                   t_gsw, n1, n2, m_out, d)
    assert torch.equal(_kernel_contract(G, qn, qp, t_gsw, n1, n2),
                       fold.fold_contract_plain(G, qn, qp, t_gsw))


def test_fold_ntt_kernel_rows():
    """K8b-1's walk: the teams of a one-wave grid (W teams a block, blocks
    cut to the units) take every unit once per limb, a source row (mo, s,
    p) whole or, when the rows are fewer than the teams of a limb's share,
    each of its carry chains [0, t_gsw // 2) and [t_gsw // 2, t_gsw); so
    every digit once; and digit k of row (mo, s, p) lands at G's (li, s, k,
    mo, p) row."""
    for d, m_out, P, t_gsw in ((2048, 64, 6, 9), (256, 3, 6, 11),
                               (2048, 1, 6, 2), (2048, 8, 6, 9)):
        W = 8 if d == 256 else 1
        rows, h = m_out * 2 * P, t_gsw // 2
        share = 132 * 2 // 2           # two blocks an SM, half a limb
        chains = 2 if rows < share * W else 1
        units = chains * rows
        blocks = min(-(-units // W), share)
        digits = np.zeros((rows, t_gsw), dtype=int)
        for b in range(blocks):
            for team in range(W):
                for u in range(b * W + team, units, blocks * W):
                    src = u >> 1 if chains == 2 else u
                    k0 = h if chains == 2 and u & 1 else 0
                    k1 = h if chains == 2 and not u & 1 else t_gsw
                    digits[src, k0:k1] += 1
        assert (digits == 1).all()
        shape = (2, 2, t_gsw, m_out, P, d)
        for li, src, k in ((1, rows - 1, t_gsw - 1), (0, 7 % rows, 1)):
            p, s, mo = src % P, (src // P) & 1, src // (2 * P)
            base = (((li * 2 + s) * t_gsw) * m_out + mo) * P + p
            assert (base + k * m_out * P) * d == np.ravel_multi_index(
                (li, s, k, mo, p, 0), shape)
