"""The port's plain NTT against the JAX mxu engine: bit equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiral_tpu.arith.ntt_mxu import CrtNttMxu
from spiral_tpu.params import B_I, P_I
from spiral_tpu_torch.arith import ntt
from spiral_tpu_torch.arith.tables import ROW_POS, ROW_REG, ntt_tables


def _residues(rng, shape):
    return np.stack([rng.integers(0, P_I, shape), rng.integers(0, B_I, shape)],
                    axis=-2).astype(np.uint32)


@pytest.mark.parametrize("d", [256, 2048])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_ntt_matches_jax_mxu(d, direction):
    x = _residues(np.random.default_rng(d), (3, d))
    want = np.asarray(getattr(CrtNttMxu(d), direction)(jnp.asarray(x)))
    got = getattr(ntt, direction)(torch.from_numpy(x.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_ntt_round_trip_and_tables():
    d = 64
    tb = ntt_tables(d)
    np.testing.assert_array_equal(tb.pos_of_slot[tb.slot_of_pos], np.arange(d))
    x = torch.from_numpy(_residues(np.random.default_rng(1), (2, 5, d))
                         .astype(np.int32))
    assert torch.equal(ntt.inverse(ntt.forward(x)), x)


# ---- the register NTT of the fold and key-switch kernels (ntt_reg.cuh) ----
M32 = (1 << 32) - 1


def _pass_schedule(L):
    """(first stage, stages) of each pass: radix-8 passes, the last with
    what is left (Sched in ntt_reg.cuh)."""
    n = (L + 2) // 3
    return [(3 * P, 3 if P < n - 1 else L - 3 * (n - 1)) for P in range(n)]


def _pass_index(L, s0, R, t, j):
    b, G = L - s0 - R, 8 >> R
    gid = t * G + (j >> R)
    return ((gid >> b) << (b + R)) | ((j & ((1 << R) - 1)) << b) | \
        (gid & ((1 << b) - 1))


def _swz(i):
    x = (i >> 5) & 7
    return i ^ ((x << 2) ^ x)


def _shoup(a, w, wp, p):
    return (a * w - ((a * wp) >> 32) * p) & M32


def _run_passes(a, rows, p, L, inverse):
    """The kernel's passes over one poly `a` (positions, uint64), thread by
    thread as vectors over the d/8 threads: each pass gathers a thread's 8
    registers at pass_index, runs its butterflies with the (w, w') pairs of
    `rows`, and scatters them back.  Asserts Harvey's lazy bounds."""
    T = (1 << L) // 8
    t = np.arange(T, dtype=np.uint64).astype(np.int64)
    w, wp = (r.view(np.uint32).astype(np.uint64) for r in rows)
    sched = _pass_schedule(L)
    for s0, R in (reversed(sched) if inverse else sched):
        b, G, M = L - s0 - R, 8 >> R, 1 << R
        idx = [_pass_index(L, s0, R, t, j) for j in range(8)]
        x = [a[i] for i in idx]
        for h in range(G):
            high = (t * G + h) >> b
            for k in (range(R - 1, -1, -1) if inverse else range(R)):
                span = M >> (k + 1)
                for u in range(1 << k):
                    wi = (1 << (s0 + k)) + (high << k) + u
                    for z in range(span):
                        e = h * M + u * 2 * span + z
                        l, r = x[e], x[e + span]
                        if inverse:      # Gentleman-Sande, [0, 2p)
                            assert (l < 2 * p).all() and (r < 2 * p).all()
                            s = l + r
                            x[e] = np.where(s >= 2 * p, s - 2 * p, s)
                            x[e + span] = _shoup(l - r + 2 * p, w[wi], wp[wi], p)
                        else:            # Cooley-Tukey, [0, 4p)
                            assert (l < 4 * p).all() and (r < 4 * p).all()
                            u2 = np.where(l >= 2 * p, l - 2 * p, l)
                            v = _shoup(r, w[wi], wp[wi], p)
                            x[e], x[e + span] = u2 + v, u2 - v + 2 * p
        for i, v in zip(idx, x):
            a[i] = v
    return a


@pytest.mark.parametrize("d", [256, 2048])
def test_register_ntt_tables(d):
    """The kernel table holds pos_of_slot at ROW_POS and the register
    core's rows from ROW_REG on, and nothing else; each twiddle's Shoup
    companion is floor(w * 2^32 / p) in Python ints, and the kernels' pass
    schedule with the lazy Shoup butterflies, driven by those rows,
    computes the plain radix-2 transforms (forward_plain /
    inverse_plain)."""
    L = d.bit_length() - 1
    tb = ntt_tables(d)
    pk = tb.packed()
    assert pk.shape == (ROW_REG + 8, d)
    np.testing.assert_array_equal(pk[ROW_POS],
                                  tb.pos_of_slot.astype(np.int32))
    for li, p in enumerate((P_I, B_I)):
        for r in (ROW_REG, ROW_REG + 2):
            w = pk[r + 4 * li].view(np.uint32)
            wp = pk[r + 1 + 4 * li].view(np.uint32)
            assert [int(c) for c in wp] == [(int(v) << 32) // p for v in w]
            assert (w < p).all()
    # every pass's indices, and the slot reads, cover a buffer once
    t = np.arange(d // 8)
    for s0, R in _pass_schedule(L):
        idx = np.concatenate([_swz(_pass_index(L, s0, R, t, j))
                              for j in range(8)])
        np.testing.assert_array_equal(np.sort(idx), np.arange(d))
    x = _residues(np.random.default_rng(d + 1), (d,))      # (2, d)
    want_f = ntt.forward_plain(torch.from_numpy(x.astype(np.int32))).numpy()
    want_i = ntt.inverse_plain(torch.from_numpy(x.astype(np.int32))).numpy()
    for li, p in enumerate((P_I, B_I)):
        rows = pk[ROW_REG + 4 * li: ROW_REG + 2 + 4 * li]
        a = _run_passes(x[li].astype(np.uint64), rows, p, L, inverse=False)
        a = np.where(a >= 2 * p, a - 2 * p, a)
        a = np.where(a >= p, a - p, a)
        np.testing.assert_array_equal(a[tb.pos_of_slot], want_f[li])
        inv = pk[ROW_REG + 2 + 4 * li: ROW_REG + 4 + 4 * li]
        a = np.zeros(d, dtype=np.uint64)
        a[tb.pos_of_slot] = x[li]
        a = _run_passes(a, inv, p, L, inverse=True)
        d_inv = inv[:, 0].view(np.uint32).astype(np.uint64)
        a = _shoup(a, d_inv[0], d_inv[1], p)
        np.testing.assert_array_equal(np.where(a >= p, a - p, a), want_i[li])


# ---- K1 and K8a on the register core: the batched kernels' indexing ----
NP_MAX, WAVE = 2, 4 * 132      # polys per team step; blocks of one wave


def _limb_steps(per_limb, g, G):
    """ntt_reg.cuh limb_steps: (first poly j, NP) of team g's steps."""
    return [(2 * s, 2 if 2 * s + 1 < per_limb else 1)
            for s in range(g, (per_limb + 1) // 2, G)]


def _teams(d, per_limb):
    """Teams in one limb's share of the grid (launch_limbs): the blocks of
    one wave split between the limbs, cut to the limb's steps."""
    W = 8 if d == 256 else 1
    need = -(-((per_limb + 1) // 2) // W)
    return min(need, max(WAVE // 2, 1)) * W


def _reduce_word(a, p):
    """ntt_reg.cuh reduce_word: a Shoup product by 1."""
    return a - ((a * (M32 // p)) >> 32) * p


def _model_batched(words, d, inverse, t_auto=None):
    """K1 (K8a with t_auto) over rows `words` (n_polys, d), row 2j + li
    poly j of limb li: each team step loads NP same-limb polys reduced on
    the load, runs the register passes through NP-form from_slots /
    to_slots buffers, and stores row entry t + e*d/8 from thread t.
    Asserts that every row is taken once, by a step of its own limb."""
    L, T = d.bit_length() - 1, d // 8
    tb, pk = ntt_tables(d), ntt_tables(d).packed()
    last = _pass_schedule(L)[-1]
    t = np.arange(T)
    regs = [_pass_index(L, *last, t, j) for j in range(8)]  # last layout
    slot = [t + e * T for e in range(8)]
    out = np.zeros(words.shape, dtype=np.uint64)
    taken = np.zeros(len(words), dtype=int)
    per_limb = len(words) // 2
    for li, p in enumerate((P_I, B_I)):
        row = ROW_REG + 4 * li + (2 if inverse else 0)
        G = _teams(d, per_limb)
        for g in range(G):
            for j, NP in _limb_steps(per_limb, g, G):
                rows = [2 * (j + q) + li for q in range(NP)]
                taken[rows] += 1
                x = [[_reduce_word(words[r][s], p) for s in slot]
                     for r in rows]
                assert all((v < 2 * p).all() for xq in x for v in xq)
                buf = np.zeros(NP * d, dtype=np.uint64)
                if inverse:      # from_slots, NP form
                    for q in range(NP):
                        for e in range(8):
                            buf[q * d + _swz(tb.pos_of_slot[slot[e]])] = \
                                x[q][e]
                    x = [[buf[q * d + _swz(regs[j])] for j in range(8)]
                         for q in range(NP)]
                for q, r in enumerate(rows):
                    a = np.zeros(d, dtype=np.uint64)
                    for e in range(8):   # registers -> positions
                        a[regs[e] if inverse else slot[e]] = x[q][e]
                    a = _run_passes(a, pk[row:row + 2], p, L, inverse)
                    if inverse:
                        dv = pk[row:row + 2, 0].view(np.uint32).astype(
                            np.uint64)
                        a = _shoup(a, dv[0], dv[1], p)
                        a = np.where(a >= p, a - p, a)
                    else:        # to_slots, then canonical
                        a = a[tb.pos_of_slot]
                        a = np.where(a >= 2 * p, a - 2 * p, a)
                        a = np.where(a >= p, a - p, a)
                    out[r] = a
                if t_auto is not None:
                    out[rows] = _model_image(out[rows], d, t_auto, p)
    np.testing.assert_array_equal(taken, 1)
    return out


def _model_image(c, d, t_auto, p):
    """K8a's tau_t store: coefficient i of poly q to word q*d + (i*t mod d)
    of an unswizzled buffer, negated when (i*t) / d is odd; asserts each
    word is written once and each warp's 32 stores hit 32 banks."""
    T, L = d // 8, d.bit_length() - 1
    NP = len(c)
    buf = np.zeros(NP * d, dtype=np.uint64)
    hits = np.zeros(NP * d, dtype=int)
    t = np.arange(T)
    for e in range(8):
        it = (e * T + t) * (t_auto % (2 * d))
        for q in range(NP):
            idx = q * d + (it & (d - 1))
            assert all(len(set(idx[w:w + 32] % 32)) == 32
                       for w in range(0, T, 32))
            v = c[q][e * T + t]
            buf[idx] = np.where(((it >> L) & 1).astype(bool) & (v > 0),
                                p - v, v)
            hits[idx] += 1
    np.testing.assert_array_equal(hits, 1)
    return buf.reshape(NP, d)


def test_batched_limb_steps():
    """K1 / K8a pair same-limb polys two at a time over the teams of one
    wave; a limb's odd last poly takes an NP = 1 step."""
    for d, per_limb in ((2048, 1), (2048, 3), (2048, 768), (2048, 4096),
                        (256, 5), (256, 1000)):
        G = _teams(d, per_limb)
        steps = [s for g in range(G) for s in _limb_steps(per_limb, g, G)]
        polys = sorted(j + q for j, NP in steps for q in range(NP))
        assert polys == list(range(per_limb))
        assert [NP for _, NP in steps].count(1) == per_limb % 2
    assert _teams(2048, 768) == WAVE // 2 and _teams(2048, 1) == 1


@pytest.mark.parametrize("d", [256, 2048])
def test_batched_ntt_model(d):
    """K1 forward and inverse and K8a at every expansion round's t, as
    numpy models of the kernels' indexing, against the plain versions on
    words up to 2^31 - 1 (3 polys per limb: one NP = 2 and one NP = 1
    step).  reduce_word maps every 32-bit word below 2p."""
    words = np.random.default_rng(d).integers(0, 1 << 31, (6, d),
                                              dtype=np.int64)
    words[0, :3] = [0, (1 << 31) - 1, P_I]
    x = torch.from_numpy(words.astype(np.int32)).reshape(3, 2, d)
    for inverse, plain in ((False, ntt.forward_plain),
                           (True, ntt.inverse_plain)):
        got = _model_batched(words.astype(np.uint64), d, inverse)
        np.testing.assert_array_equal(got.reshape(3, 2, d),
                                      plain(x).numpy())
    from spiral_tpu_torch.core.poly import automorph_raw
    coeff = ntt.inverse_plain(x)
    for r in (0, 3, d.bit_length() - 2):
        t = (d >> r) + 1
        got = _model_batched(words.astype(np.uint64), d, True, t)
        np.testing.assert_array_equal(got.reshape(3, 2, d),
                                      automorph_raw(coeff, t).numpy())
    for r in range(d.bit_length() - 1):     # every round's t: the map alone
        c = np.arange(2 * d, dtype=np.uint64).reshape(2, d) % P_I
        _model_image(c, d, (d >> r) + 1, P_I)
    a = np.array([0, 1, P_I - 1, P_I, 2 * P_I - 1, (1 << 31) - 1, M32],
                 dtype=np.uint64)
    for p in (P_I, B_I):
        r = _reduce_word(a, p)
        assert (r < 2 * p).all() and (r % p == a % p).all()
