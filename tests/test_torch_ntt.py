"""The port's plain NTT against the JAX mxu engine: bit equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spiral_tpu.arith.ntt_mxu import CrtNttMxu
from spiral_tpu.params import B_I, P_I
from spiral_tpu_torch.arith import ntt
from spiral_tpu_torch.arith.tables import ntt_tables


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
    """Rows 10-17 of the kernel table: each twiddle's Shoup companion is
    floor(w * 2^32 / p) in Python ints, and the kernels' pass schedule
    with the lazy Shoup butterflies, driven by those rows, computes the
    radix-2 transforms that ntt.cuh's twist, omega and untwist rows do
    (forward_plain / inverse_plain)."""
    L = d.bit_length() - 1
    tb = ntt_tables(d)
    pk = tb.packed()
    np.testing.assert_array_equal(pk[:10], np.stack(
        [r for li in range(2) for r in (tb.twist[li], tb.untwist[li],
                                        tb.omega[li], tb.omega_inv[li])] +
        [tb.pos_of_slot, tb.slot_of_pos]).astype(np.int32))
    for li, p in enumerate((P_I, B_I)):
        for r in (10, 12):
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
        rows = pk[10 + 4 * li: 12 + 4 * li]
        a = _run_passes(x[li].astype(np.uint64), rows, p, L, inverse=False)
        a = np.where(a >= 2 * p, a - 2 * p, a)
        a = np.where(a >= p, a - p, a)
        np.testing.assert_array_equal(a[tb.pos_of_slot], want_f[li])
        inv = pk[12 + 4 * li: 14 + 4 * li]
        a = np.zeros(d, dtype=np.uint64)
        a[tb.pos_of_slot] = x[li]
        a = _run_passes(a, inv, p, L, inverse=True)
        d_inv = inv[:, 0].view(np.uint32).astype(np.uint64)
        a = _shoup(a, d_inv[0], d_inv[1], p)
        np.testing.assert_array_equal(np.where(a >= p, a - p, a), want_i[li])
