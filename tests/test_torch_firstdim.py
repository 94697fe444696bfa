"""K2's arithmetic (csrc/firstdim.cu) on the CPU: the port's limb model
``firstdim.multiply_limbs_plain`` against the plain multiply and the JAX
package's int8-limb first-dim multiply, on worst-case words, and a numpy
model of the kernel's stages, prescale, fragments and epilogue (the
registers each lane loads, the m16n8k32 MMA's layout, the shared-memory
swizzle and its banks) against the plain multiply.  All arithmetic is exact: the
tolerance is 0."""
import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from spiral_tpu.params import B_I, P_I
from spiral_tpu.server.firstdim import (db_to_mxu_limbs,
                                        multiply_query_by_db_mxu,
                                        multiply_query_by_db_mxu_batch)
from spiral_tpu_torch.server import firstdim

MODS = (P_I, B_I)


def _residues(rng, shape, axis):
    return np.stack([rng.integers(0, p, shape) for p in MODS],
                    axis=axis).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


@pytest.fixture(scope="module")
def jax_case():
    """A tiny database and a batch of 3 queries, JAX's batched and
    single-query int8-limb multiplies run once for the module."""
    rng = np.random.default_rng(7)
    num_per, n2, K, d, B, n1 = 4, 2, 16, 8, 3, 2
    data = _residues(rng, (num_per, n2, K, d), 3)     # JAX (np, n2, K, 2, d)
    qk = _residues(rng, (B, K, n1, d), 3)             # (B, K, n1, 2, d)
    limbs = db_to_mxu_limbs(jnp.asarray(data))
    want_b = np.asarray(multiply_query_by_db_mxu_batch(limbs, jnp.asarray(qk)))
    want_1 = np.asarray(multiply_query_by_db_mxu(limbs, jnp.asarray(qk[0])))
    db = data.transpose(3, 4, 2, 0, 1).reshape(2, d, K, num_per * n2)
    return _t(db), _t(qk), want_b, want_1


FORMS = pytest.mark.parametrize("prescaled", [False, True],
                                ids=["pairs", "prescaled"])


@FORMS
def test_limb_model_matches_jax_batch(jax_case, prescaled):
    db, qk, want_b, _ = jax_case
    got = firstdim.multiply_limbs_plain(db, qk, prescaled=prescaled)
    np.testing.assert_array_equal(got.numpy(), want_b.astype(np.int64))
    assert torch.equal(got, firstdim.multiply_batch_plain(db, qk))


@FORMS
def test_limb_model_matches_jax_single(jax_case, prescaled):
    db, qk, _, want_1 = jax_case
    got = firstdim.multiply_limbs_plain(db, qk[:1],
                                        prescaled=prescaled)[:, :, 0]
    np.testing.assert_array_equal(got.numpy(), want_1.astype(np.int64))
    assert torch.equal(got, firstdim.multiply_plain(db, qk[0]))


@FORMS
@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_limb_model_matches_plain_chunked(chunks, prescaled):
    rng = np.random.default_rng(chunks)
    db = _t(_residues(rng, (8, 40, 12), 0))
    qk = _t(_residues(rng, (2, 40, 3, 8), 3))
    assert torch.equal(
        firstdim.multiply_limbs_plain(db, qk, chunks, prescaled=prescaled),
        firstdim.multiply_batch_plain(db, qk, chunks))


# every word p - 1, and every word 2^32 - 1 (8-bit limbs make any 32-bit
# word exact; the plain multiply gets the words reduced mod p), at the
# largest K the kernel takes, where the int32 limb sums come closest to
# 2^31; one K more raises
@FORMS
@pytest.mark.parametrize("word", ["p-1", "2^32-1"])
def test_limb_model_worst_words(word, prescaled):
    d, K, m, B, n1 = 2, firstdim.K_MAX, 3, 1, 2
    mods = torch.tensor(MODS)
    if word == "p-1":
        db = (mods - 1).view(2, 1, 1, 1).expand(2, d, K, m).int()
        qk = (mods - 1).view(2, 1).expand(B, K, n1, 2, d).int()
        db_r, qk_r = db, qk
    else:
        db = torch.full((2, d, K, m), -1, dtype=torch.int32)
        qk = torch.full((B, K, n1, 2, d), -1, dtype=torch.int32)
        db_r = (((1 << 32) - 1) % mods).view(2, 1, 1, 1).expand(
            2, d, K, m).int()
        qk_r = (((1 << 32) - 1) % mods).view(2, 1).expand(
            B, K, n1, 2, d).int()
    assert torch.equal(
        firstdim.multiply_limbs_plain(db, qk, prescaled=prescaled),
        firstdim.multiply_batch_plain(db_r, qk_r))
    with pytest.raises(ValueError):
        firstdim.multiply_limbs_plain(
            torch.zeros((2, d, K + 1, m), dtype=torch.int32),
            torch.zeros((B, K + 1, n1, 2, d), dtype=torch.int32),
            prescaled=prescaled)


# ---- a numpy model of the kernel: its block geometry, stages, registers,
# MMA fragments and epilogues, both forms (csrc/firstdim.cu) ----
MAX_WARPS, MAX_ROWS, PRESCALED_ROWS = 12, 64, 8
SMEM_SM, STAGE_DB_WORDS, BOX = 220 << 10, 4096, 32


def _bulk(m, G, gn, K):
    """spiral_firstdim's choice of the query's bulk copy (16-byte aligned
    tensors)."""
    return m % 4 == 0 and gn == G and K * G % 4 == 0


def _geometry(gn, m, bulk):
    """csrc/firstdim.cu Geometry, with the bytes of a ring of 3 stages (the
    shallowest a launch picks)."""
    pairs = gn > PRESCALED_ROWS
    wcols = 16 if pairs else 32
    nt = (gn + 7) // 8 if pairs else (gn + 1) // 2
    nw = (2 if nt >= 4 else 1) if pairs else 2
    ng = (nt + nw - 1) // nw
    warps = MAX_WARPS if pairs and nt > 3 else 8
    lmt = 3
    while lmt > 0 and (ng << lmt) > warps:
        lmt -= 1
    while lmt > 0 and (wcols << (lmt - 1)) >= m:
        lmt -= 1
    mt = 1 << lmt
    mb = wcols * mt
    mbl = (mb + BOX - 1) // BOX * BOX
    gq = 8 * nt + (12 if nt & 1 else 4) if pairs and not bulk else gn
    nl = 0 if pairs else 8 * nt + 4
    ks = 32
    while ks * 2 * mbl <= STAGE_DB_WORDS:
        ks *= 2

    def smem3(ks):
        stage_words = (ks * (mbl + gq) + 8 + 255) // 256 * 256
        return (3 * stage_words + 2 * ks * nl + 256) * 4
    while ks > 32 and smem3(ks) > SMEM_SM:
        ks //= 2
    return dict(pairs=pairs, nt=nt, nw=nw, ng=ng, mt=mt, mb=mb, mbl=mbl,
                gq=gq, nl=nl, ks=ks, threads=32 * mt * ng, smem3=smem3(ks))


def _db_word(ks, r, w):
    """db_word: boxes of 32 columns, rows of 128 B, 16-byte chunks XORed
    with the row mod 8 (TMA's 128-byte swizzle)."""
    return ((w >> 5) * ks * BOX + r * BOX + ((((w >> 2) & 7) ^ (r & 7)) << 2)
            + (w & 3))


def _k_row(hk, tig, c):
    """The pair form's depth order."""
    return 16 * hk + 2 * tig + 8 * (c >> 1) + (c & 1)


def _bytes_t(w):
    """bytes_t: four words -> word j holds byte j of each, word 0 lowest."""
    w = [np.asarray(x, dtype=np.uint64) for x in w]
    return [sum(((w[c] >> (8 * j)) & 0xFF) << (8 * c) for c in range(4))
            for j in range(4)]


def _byte(x, b):
    return ((np.asarray(x, dtype=np.uint64) >> (8 * b)) & 0xFF).astype(
        np.int64)


def _mma(a, b):
    """mma.m16n8k32 u8 x u8 -> s32 from per-lane registers: a (4, 32) and
    b (2, 32) u32 by lane; returns c (4, 32) by lane.  PTX's fragment
    layouts: A byte i of register h at row g + 8 (h & 1), depth 4 tig + i
    + 16 (h >> 1); B byte i of register h at depth 4 tig + i + 16 h,
    column g; C register e at row g + 8 (e >> 1), column 2 tig + (e & 1)."""
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for h in range(4):
        for i in range(4):
            A[g + 8 * (h & 1), 4 * tig + i + 16 * (h >> 1)] = _byte(a[h], i)
    for h in range(2):
        for i in range(4):
            B[4 * tig + i + 16 * h, g] = _byte(b[h], i)
    C = A @ B
    return np.stack([C[g + 8 * (e >> 1), 2 * tig + (e & 1)]
                     for e in range(4)])


def _shoup(a, w, p):
    """Shoup product by the constant w, asserted in [0, 2p)."""
    r = a * w - ((a * ((w << 32) // p)) >> 32) * p
    assert r.min() >= 0 and r.max() < 2 * p
    return r


def _pairs_step(sdb, sq, r0, geo, warp, acc):
    """One warp's 32 rows of a stage, pair form: limb planes of two columns
    (A) and of one query row (B) a lane, 16 limb-pair MMAs a query tile
    into the seven weight groups acc[(warp, u, s)]."""
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    wm, wn = warp % geo["mt"], warp // geo["mt"]
    ccol, ks = wm * 16 + 2 * g, geo["ks"]
    a = [[None] * 4 for _ in range(4)]
    for hk in range(2):
        rows = [r0 + _k_row(hk, tig, c) for c in range(4)]
        for h, off in ((2 * hk, 0), (2 * hk + 1, 1)):
            words = [sdb[[_db_word(ks, int(r), int(w) + off)
                          for r, w in zip(rr, ccol)]] for rr in rows]
            for j, v in enumerate(_bytes_t(words)):
                a[j][h] = v
    for u in range(geo["nw"]):
        nt = wn * geo["nw"] + u
        if nt >= geo["nt"]:
            break
        b = [[None, None] for _ in range(4)]
        for hk in range(2):
            words = [sq[r0 + _k_row(hk, tig, c), nt * 8 + g]
                     for c in range(4)]
            for i, v in enumerate(_bytes_t(words)):
                b[i][hk] = v
        for i in range(4):
            for j in range(4):
                key = (warp, u, i + j)
                acc[key] = acc.get(key, 0) + _mma(a[j], b[i])


def _prescale(sq, geo, gn, p):
    """The prescaled form's slice: pb[k, 4c + i] = limb plane i of
    (Q_0, .., Q_3), Q_j = 2^(8j) q mod p; columns past 4 gn zero."""
    pb = np.zeros((geo["ks"], geo["nl"]), np.uint64)
    for r in range(geo["ks"]):
        for c in range(gn):
            q0 = int(sq[r, c]) % p
            Q = [q0 * ((1 << (8 * j)) % p) % p for j in range(4)]
            pb[r, 4 * c:4 * c + 4] = _bytes_t(Q)
    return pb


def _prescaled_step(sdb, pb, r0, geo, warp, acc):
    """One warp's 8-row depth step, prescaled form: rows r0 + 2 tig + h of
    columns 4g .. 4g + 3 (two M tiles), B from the prescaled slice, the
    MMAs into acc[(warp, t, u)]."""
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    wm, wn = warp % geo["mt"], warp // geo["mt"]
    ccol, ks = wm * 32 + 4 * g, geo["ks"]
    x = [[sdb[[_db_word(ks, int(r), int(w) + e) for r, w in
               zip(r0 + 2 * tig + h, ccol)]] for e in range(4)]
         for h in range(2)]
    for u in range(geo["nw"]):
        nt = wn * geo["nw"] + u
        if nt >= geo["nt"]:
            break
        b = [pb[r0 + 2 * tig, nt * 8 + g], pb[r0 + 2 * tig + 1, nt * 8 + g]]
        for t in range(2):
            a = [x[0][2 * t], x[0][2 * t + 1], x[1][2 * t], x[1][2 * t + 1]]
            key = (warp, t, u)
            acc[key] = acc.get(key, 0) + _mma(a, b)


def _kernel_model(db, q, d, K, m, G, g0, gn, chunks, out, bulk):
    """One pass of firstdim_kernel, tile by tile and warp by warp, lanes
    vectorised: the stages as the copies fill them (zero past K and m), the
    registers as the lanes load them, the MMAs by their fragment layouts,
    the epilogue's Shoup products and stores."""
    geo = _geometry(gn, m, bulk)
    assert geo["threads"] <= 32 * MAX_WARPS and geo["smem3"] <= SMEM_SM
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    KS = geo["ks"]
    nk = (K + KS - 1) // KS
    for chunk, li, z in itertools.product(range(chunks), range(2), range(d)):
        p = MODS[li]
        zq = (z - chunk) % d
        for col0 in range(0, m, geo["mb"]):
            acc = {}
            for t in range(nk):
                sdb = np.zeros(KS * geo["mbl"], np.uint64)
                # the pair form reads up to 8 columns past a dense row
                sq = np.zeros((KS, geo["gq"] + 8), np.uint64)
                for r in range(min(KS, K - t * KS)):
                    k = t * KS + r
                    for c in range(min(geo["mb"], m - col0)):
                        sdb[_db_word(KS, r, c)] = db[li, z, k, col0 + c]
                    sq[r, :gn] = q[li, zq, k, g0:g0 + gn]
                if bulk:                 # dense rows: past a row, the next
                    flat = sq[:, :gn].ravel()
                    flat = np.concatenate([flat, np.zeros(8, np.uint64)])
                    for r in range(KS):
                        sq[r, :gn + 8] = flat[r * gn:r * gn + gn + 8]
                if geo["pairs"]:
                    for warp, r0 in itertools.product(
                            range(geo["threads"] // 32), range(0, KS, 32)):
                        _pairs_step(sdb, sq, r0, geo, warp, acc)
                else:
                    pb = _prescale(sq, geo, gn, p)
                    for warp, r0 in itertools.product(
                            range(geo["threads"] // 32), range(0, KS, 8)):
                        _prescaled_step(sdb, pb, r0, geo, warp, acc)
            for o in acc.values():
                assert o.max() < 1 << 31
            for warp in range(geo["threads"] // 32):
                wm, wn = warp % geo["mt"], warp // geo["mt"]
                for u in range(geo["nw"]):
                    nt = wn * geo["nw"] + u
                    if nt >= geo["nt"]:
                        break
                    if geo["pairs"]:
                        for e in range(4):
                            x = sum(_shoup(acc[(warp, u, s)][e],
                                           (1 << (8 * s)) % p, p)
                                    for s in range(7))
                            col = col0 + wm * 16 + 2 * g + (e >> 1)
                            n = nt * 8 + 2 * tig + (e & 1)
                            ok = (col < m) & (n < gn)
                            out[li, z, g0 + n[ok],
                                chunk * m + col[ok]] = x[ok] % p
                        continue
                    for tt, h in itertools.product(range(2), range(2)):
                        o = acc[(warp, tt, u)]
                        i0 = 2 * (tig & 1)
                        x = sum(_shoup(o[2 * h + e],
                                       np.array([(1 << (8 * (i0v + e))) % p
                                                 for i0v in i0]), p)
                                for e in range(2))
                        x = x + x[lane ^ 1]
                        col = col0 + wm * 32 + 4 * g + 2 * tt + h
                        n = 2 * nt + (tig >> 1)
                        ok = ((tig & 1) == 0) & (col < m) & (n < gn)
                        out[li, z, g0 + n[ok], chunk * m + col[ok]] = \
                            x[ok] % p


@pytest.mark.parametrize("B, n1, K, m, chunks", [
    (1, 3, 40, 36, 2),      # prescaled: two N tiles, ragged K and m
    (4, 2, 32, 16, 1),      # prescaled: one column block
    (2, 3, 64, 50, 1),      # prescaled: m not a multiple of 4
    (3, 3, 40, 36, 1),      # pairs: one tile of 9 rows, dense query rows
    (3, 3, 30, 36, 1),      # the same, K G % 4 != 0: query by cp.async
    (14, 3, 32, 20, 1),     # pairs: 42 rows, 6 query tiles, two a warp
    (17, 4, 40, 36, 1)])    # two passes: 64 rows by cp.async (pairs), 4
def test_kernel_model_matches_plain(B, n1, K, m, chunks):
    rng = np.random.default_rng(B * 100 + K)
    d = 2
    db = _residues(rng, (d, K, m), 0)
    qk = _residues(rng, (B, K, n1, d), 3)
    db[0, 0, 0, 0] = qk[0, 0, 0, 1, 0] = (1 << 32) - 1     # any 32-bit word
    G = B * n1
    q = qk.transpose(3, 4, 1, 0, 2).reshape(2, d, K, G)
    out = np.zeros((2, d, G, chunks * m), np.int64)
    per_pass = max(1, min(16, MAX_ROWS // n1))
    for b0 in range(0, B, per_pass):
        nb = min(per_pass, B - b0)
        _kernel_model(db.astype(np.uint64), q.astype(np.uint64), d, K, m, G,
                      b0 * n1, nb * n1, chunks, out,
                      _bulk(m, G, nb * n1, K))
    red = [(db.astype(np.int64) % np.array(MODS).reshape(2, 1, 1, 1)),
           (qk.astype(np.int64) % np.array(MODS).reshape(1, 1, 1, 2, 1))]
    want = firstdim.multiply_batch_plain(_t(red[0]), _t(red[1]), chunks)
    np.testing.assert_array_equal(out.reshape(want.shape), want.numpy())


@pytest.mark.parametrize("m", [16, 36, 100, 102, 128, 256, 2048])
def test_kernel_geometry_and_banks(m):
    """Every pass shape (1 to 64 query rows) fits the block (<= 12 warps,
    a ring of 3 stages in 220 KB); the swizzled layout is a bijection of
    each box; a warp's A loads hit distinct banks in each phase (pair
    form: 8 bytes a lane, 16-lane phases; prescaled: 16 bytes, 8-lane
    phases), and its B loads 32 distinct banks (from padded query rows in
    the pair form, the prescaled slice in the other)."""
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    db_word = np.vectorize(_db_word)
    shapes = set()
    for gn, bulk in itertools.product(range(1, MAX_ROWS + 1), (False, True)):
        geo = _geometry(gn, m, bulk)
        assert geo["threads"] <= 32 * MAX_WARPS and geo["smem3"] <= SMEM_SM
        # the pair form's B loads are conflict-free from padded rows only
        if not (geo["pairs"] and bulk):
            shapes.add(tuple(geo[k] for k in ("pairs", "ks", "mbl", "mt",
                                              "nt", "gq", "nl")))
    for pairs, ks, mbl, mt, nt, gq, nl in sorted(shapes):
        r, w = np.meshgrid(np.arange(ks), np.arange(mbl))
        assert sorted(db_word(ks, r, w).ravel()) == list(range(ks * mbl))
        for wm in range(mt):
            if pairs:
                for hk, c in itertools.product(range(2), range(4)):
                    rr = _k_row(hk, tig, c)
                    addr = db_word(ks, rr, wm * 16 + 2 * g)
                    for half in (lane < 16, lane >= 16):
                        assert len(set((addr[half] // 2) % 16)) == 16
                    for t in range(nt):
                        assert len(set((rr * gq + t * 8 + g) % 32)) == 32
            else:
                for h in range(2):
                    addr = db_word(ks, 2 * tig + h, wm * 32 + 4 * g)
                    for ph in range(4):
                        assert len(set((addr[8 * ph:8 * ph + 8] // 4)
                                       % 8)) == 8
                    for t in range(nt):
                        assert len(set(((2 * tig + h) * nl + t * 8 + g)
                                       % 32)) == 32
    assert sorted(_k_row(hk, t, c) for hk in range(2) for t in range(4)
                  for c in range(4)) == list(range(32))
