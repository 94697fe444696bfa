"""CUDA kernels K1-K10 against their plain PyTorch versions on the card,
bit for bit.  Every test is marked `gpu` and takes the `cuda` fixture, which
skips it on a machine without a CUDA device.  On the card (no jax there, so skip the suite's
conftest, which imports it):
    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""
import dataclasses
from collections import defaultdict

import pytest
import torch

from spiral_tpu_torch.params import B_I, P_I, preset
from spiral_tpu_torch import kernels
from spiral_tpu_torch.arith import ntt
from spiral_tpu_torch.core import sampling
from spiral_tpu_torch.crypto.query import seed_words
from spiral_tpu_torch.server import convert, expand, firstdim, fold, pack

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kernels.lib()
    kernels.reset_launches()
    return torch.Generator(device="cuda").manual_seed(0)


def _residues(gen, shape):
    limbs = [torch.randint(0, p, shape, generator=gen, dtype=torch.int32,
                           device="cuda") for p in (P_I, B_I)]
    return torch.stack(limbs, dim=-2)


def _same(got, want, kernel, launches=1):
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.LAUNCHES[kernel] == launches


# K1 pairs a limb's polys on its teams, the last alone when their count is
# odd; any int32 word is reduced on the load
@pytest.mark.parametrize("d", [256, 2048])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("per_limb", [1, 3, 768])
def test_ntt_kernel(cuda, d, direction, per_limb):
    x = torch.randint(0, (1 << 31) - 1, (per_limb, 2, d), generator=cuda,
                      dtype=torch.int32, device="cuda")
    x[0, :, :2] = torch.tensor([0, (1 << 31) - 1], dtype=torch.int32)
    _same(getattr(ntt, direction)(x),
          getattr(ntt, direction + "_plain")(x), "ntt")


def test_register_ntt_degrees_only(cuda):
    """K1 and K8a are built for kernels.REG_NTT_DEGREES only."""
    x = _residues(cuda, (3, 64))
    for call in (ntt.forward, ntt.inverse,
                 lambda x: expand.inv_ntt_automorph(x, 65)):
        with pytest.raises(ValueError):
            call(x)
    assert kernels.LAUNCHES["ntt"] == kernels.LAUNCHES["auto"] == 0


def test_firstdim_kernel(cuda):
    d, K, m, n1 = 64, 512, 256, 3
    db = _residues(cuda, (d, K, m)).permute(2, 0, 1, 3).contiguous()
    qk = _residues(cuda, (K, n1, d))
    _same(firstdim.multiply_query_by_db(db, qk),
          firstdim.multiply_plain(db, qk), "firstdim")


# the fold template runs a cluster of 2*n1 blocks per (output ct, column,
# limb), each through t_gsw digit NTTs two at a time: m_out 1 (one cluster
# per column and limb) to 5, even and odd t_gsw; the presets' digit widths
# (FOLD_T_GSW: 28-bit digits at t_gsw 2, 19 at 3, 12 at 5, 8 at 8, 7 at 9,
# 6 at 11), odd ones with two carry chains of unequal length
FOLD_SHAPES = [(d, m_out) for d in (256, 2048) for m_out in (1, 2, 4, 5)]
FOLD_T_GSW = [2, 3, 5, 8, 9, 11]


@pytest.mark.parametrize("d, m_out", FOLD_SHAPES)
@pytest.mark.parametrize("t_gsw", FOLD_T_GSW)
def test_fold_kernel(cuda, t_gsw, d, m_out):
    cts = _residues(cuda, (2 * m_out, 3, 2, d))
    qn, qp = (_residues(cuda, (3, 3 * t_gsw, d)) for _ in range(2))
    _same(fold.fold_round(cts, qn, qp, t_gsw),
          fold.fold_round_plain(cts, qn, qp, t_gsw), "fold")


# every (cts, digits) of the expansion's launches at spiral_20_256 (m 8 and
# 56) and spiral_24_256 (m 16 and 56, 122 cts at its stopround); K4 runs a
# cluster of ceil((m + 1) / 3) <= 8 blocks per (ct, limb)
@pytest.mark.parametrize("d", [256, 2048])
@pytest.mark.parametrize("m", [8, 16, 56])
@pytest.mark.parametrize("N", [1, 2, 4, 8, 16, 32, 64, 122, 128, 256])
def test_expand_kernel(cuda, m, N, d):
    cv, ca = (_residues(cuda, (N, 2, 1, d)) for _ in range(2))
    W = _residues(cuda, (2, m, d))
    _same(expand.keyswitch(cv, ca, W, m),
          expand.keyswitch_plain(cv, ca, W, m), "expand")


@pytest.mark.parametrize("d, m_out", FOLD_SHAPES)
@pytest.mark.parametrize("t_gsw", FOLD_T_GSW)
def test_fold_pack_kernel(cuda, t_gsw, d, m_out):
    cts = _residues(cuda, (3, 2 * m_out, 2, 1, d))
    qn, qp = (_residues(cuda, (2, 2 * t_gsw, d)) for _ in range(2))
    _same(fold.fold_pack_round(cts, qn, qp, t_gsw),
          fold.fold_pack_round_plain(cts, qn, qp, t_gsw), "fold_pack")


@pytest.mark.parametrize("out_n, m_conv", [(2, 4), (4, 4), (4, 56)])
def test_pack_kernel(cuda, out_n, m_conv):
    d = 2048
    cts = _residues(cuda, (out_n * out_n, 2, 1, d))
    v_W = _residues(cuda, (out_n, out_n + 1, m_conv, d))
    _same(pack.pack_ciphertexts(cts, v_W),
          pack.pack_ciphertexts_plain(cts, v_W), "pack")


# B queries of n1 rows: one pass takes at most 16 queries and 64 rows (8
# query tiles of the MMA), so 11 queries at K = 2,048 run in one pass and
# 17 in two; chunked (the implicit mode) with a roll of the query per
# chunk; m = 100 is no multiple of the 16-column tile, m = 102 no multiple
# of 4 either (the stage fills with 4-byte copies); the stream databases'
# shapes at B = 1 and 8: spiralstream_20_256 (K 1,024, n1 3, m 128) and
# spiralstreampack_20_256 (K 64, n1 2, m 1,024)
@pytest.mark.parametrize("B, n1, K, m, chunks", [
    (1, 3, 1024, 128, 1), (8, 3, 1024, 128, 1), (1, 2, 64, 1024, 1),
    (8, 2, 64, 1024, 1), (8, 3, 512, 128, 1), (8, 2, 512, 128, 1), (11, 3, 2048, 128, 1),
    (2, 3, 512, 128, 3), (8, 3, 1024, 128, 2), (3, 2, 256, 100, 2),
    (1, 3, 64, 256, 1), (1, 1, 1024, 100, 3), (1, 4, 64, 102, 2),
    (8, 1, 64, 2048, 1), (8, 4, 1024, 102, 1), (8, 2, 64, 100, 3),
    (16, 3, 1024, 128, 1), (16, 4, 64, 102, 2), (16, 2, 1024, 100, 3),
    (16, 1, 64, 256, 1), (17, 3, 64, 256, 1), (17, 2, 1024, 100, 3),
    (17, 4, 64, 102, 2), (17, 1, 1024, 128, 1)])
def test_firstdim_batch_kernel(cuda, B, n1, K, m, chunks):
    d = 64
    db = _residues(cuda, (d, K, m)).permute(2, 0, 1, 3).contiguous()
    qk = _residues(cuda, (B, K, n1, d))
    _same(firstdim.multiply_query_by_db_batch(db, qk, chunks),
          firstdim.multiply_batch_plain(db, qk, chunks), "firstdim",
          firstdim.passes(B, K, n1))
    assert firstdim.passes(11, 2048, 3) == 1
    assert firstdim.passes(8, 1024, 3) == 1
    assert firstdim.passes(16, 1024, 4) == 1
    assert firstdim.passes(17, 64, 3) == 2


# worst-case words at the largest K the kernel takes: every word p - 1 and
# every word 2^32 - 1 (int32 -1; the plain version then gets the words
# reduced mod p, which is what K2 computes with); one K more raises
@pytest.mark.parametrize("word", ["p-1", "2^32-1"])
@pytest.mark.parametrize("B, n1", [(1, 3), (8, 3), (17, 2)])
def test_firstdim_kernel_worst_words(cuda, word, B, n1):
    d, K, m = 4, firstdim.K_MAX, 36
    mods = torch.tensor([P_I, B_I], device="cuda")
    if word == "p-1":
        db = (mods - 1).view(2, 1, 1, 1).expand(2, d, K, m).int().contiguous()
        qk = (mods - 1).view(2, 1).expand(B, K, n1, 2, d).int().contiguous()
        db_r, qk_r = db, qk
    else:
        db = torch.full((2, d, K, m), -1, dtype=torch.int32, device="cuda")
        qk = torch.full((B, K, n1, 2, d), -1, dtype=torch.int32,
                        device="cuda")
        db_r = ((1 << 32) - 1) % mods.view(2, 1, 1, 1).expand(2, d, K, m)
        qk_r = ((1 << 32) - 1) % mods.view(2, 1).expand(B, K, n1, 2, d)
        db_r, qk_r = db_r.int().contiguous(), qk_r.int().contiguous()
    _same(firstdim.multiply_query_by_db_batch(db, qk, 2),
          firstdim.multiply_batch_plain(db_r, qk_r, 2), "firstdim",
          firstdim.passes(B, K, n1))
    big = torch.zeros((2, d, K + 1, 4), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        firstdim.multiply_query_by_db(big, torch.zeros(
            (K + 1, 1, 2, d), dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("m_out", [1, 2, 5])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("t_gsw", FOLD_T_GSW)
def test_fold_batch_kernel(cuda, t_gsw, B, m_out):
    d = 2048
    cts = _residues(cuda, (B, 2 * m_out, 3, 2, d))
    qn, qp = (_residues(cuda, (B, 3, 3 * t_gsw, d)) for _ in range(2))
    _same(fold.fold_round_batch(cts, qn, qp, t_gsw),
          fold.fold_round_plain(cts, qn, qp, t_gsw), "fold_batch")


@pytest.mark.parametrize("m_out", [1, 2, 5])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("t_gsw", FOLD_T_GSW)
def test_fold_pack_batch_kernel(cuda, t_gsw, B, m_out):
    d = 2048
    cts = _residues(cuda, (B, 4, 2 * m_out, 2, 1, d))
    qn, qp = (_residues(cuda, (B, 2, 2 * t_gsw, d)) for _ in range(2))
    _same(fold.fold_pack_round_batch(cts, qn, qp, t_gsw),
          fold.fold_pack_round_plain(cts, qn, qp, t_gsw), "fold_pack_batch")


# K7 runs a cluster of out_n blocks per (column, limb), block r through
# trial row r's m_conv + 1 NTTs two at a time (an odd count leaves a last
# step of one poly)
@pytest.mark.parametrize("d", [256, 2048])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("m_conv", [1, 4, 56])
@pytest.mark.parametrize("out_n", [2, 4, 8])
def test_pack_kernel_shapes(cuda, out_n, m_conv, B, d):
    cts = _residues(cuda, (B, out_n * out_n, 2, 1, d))
    v_W = _residues(cuda, (out_n, out_n + 1, m_conv, d))
    _same(pack.pack_ciphertexts(cts, v_W),
          pack.pack_ciphertexts_plain(cts, v_W), "pack")


def test_pack_kernel_degrees_only(cuda):
    """K7 is built for kernels.REG_NTT_DEGREES only."""
    cts = _residues(cuda, (4, 2, 1, 64))
    v_W = _residues(cuda, (2, 3, 4, 64))
    with pytest.raises(ValueError):
        pack.pack_ciphertexts(cts, v_W)
    assert kernels.LAUNCHES["pack"] == 0


def test_pack_batch_kernel(cuda):
    d, out_n, m_conv = 2048, 4, 4
    cts = _residues(cuda, (3, out_n * out_n, 2, 1, d))
    v_W = _residues(cuda, (out_n, out_n + 1, m_conv, d))
    _same(pack.pack_ciphertexts(cts, v_W),
          pack.pack_ciphertexts_plain(cts, v_W), "pack")


# K8a at every expansion round's t = d/2^r + 1 (r = 0 .. 8 at d = 2048,
# 0 .. 7 at d = 256): 5 cts (10 polys a limb), and 5 polys a limb (the
# last alone)
@pytest.mark.parametrize("d, r", [(d, r) for d in (256, 2048)
                                  for r in range(d.bit_length() - 1)
                                  if r <= 8])
def test_auto_kernel(cuda, d, r):
    t = (d >> r) + 1
    for shape in ((5, 2, 1), (5,)):
        x = _residues(cuda, shape + (d,))
        _same(expand.inv_ntt_automorph(x, t),
              expand.inv_ntt_automorph_plain(x, t), "auto")
        kernels.reset_launches()


# K8b-1 on the register core: a team per source row, m_out 1 (two rows
# a limb at d = 2048) and a ragged count (the teams of a d = 256 block
# outnumber the rows)
@pytest.mark.parametrize("m_out", [1, 5])
@pytest.mark.parametrize("d", [256, 2048])
@pytest.mark.parametrize("t_gsw", [8, 9, 11])
def test_fold_ntt_kernel(cuda, t_gsw, d, m_out):
    pairs = _residues(cuda, (m_out, 2, 3, 2, d))
    _same(fold.fold_ntt(pairs, t_gsw), fold.fold_ntt_plain(pairs, t_gsw),
          "fold_ntt")


def test_fold_ntt_degrees_only(cuda):
    """K8b-1 is built for kernels.REG_NTT_DEGREES only."""
    with pytest.raises(ValueError):
        fold.fold_ntt(_residues(cuda, (2, 2, 3, 2, 64)), 9)
    assert kernels.LAUNCHES["fold_ntt"] == 0


# K8b-2: m_out 37 (74 columns: ten tiles of 8, the last ragged, over
# several column ranges at d = 256), m_out 5 and m_out 1 (one tile, 2 of
# its 8 columns), on random residues and on p - 1 everywhere
@pytest.mark.parametrize("words", ["random", "worst"])
@pytest.mark.parametrize("d, m_out", [(256, 37), (2048, 5), (2048, 1)])
@pytest.mark.parametrize("t_gsw", [8, 9, 11])
def test_fold_contract_kernel(cuda, t_gsw, d, m_out, words):
    G = _residues(cuda, (2, t_gsw, m_out, 6, d)).permute(
        4, 0, 1, 2, 3, 5).contiguous()
    qn, qp = (_residues(cuda, (3, 3 * t_gsw, d)) for _ in range(2))
    if words == "worst":      # G's limb axis leads, q's is -2
        G[0], G[1] = P_I - 1, B_I - 1
        for q in (qn, qp):
            q[..., 0, :], q[..., 1, :] = P_I - 1, B_I - 1
    _same(fold.fold_contract(G, qn, qp, t_gsw),
          fold.fold_contract_plain(G, qn, qp, t_gsw), "fold_contract")


@pytest.mark.parametrize("t_gsw", [9, 11])
def test_fold_mxu_rounds_kernels(cuda, monkeypatch, t_gsw):
    """A whole mxu fold (K8b-1, K8b-2, K1 a round) equals K3's."""
    from spiral_tpu_torch.params import Params
    p = Params(nu_1=2, nu_2=3, p_db=256, t_gsw=t_gsw, t_conv=4, t_exp=8,
               t_exp_right=8)
    cts = _residues(cuda, (8, 3, 2, p.poly_len))
    qp, qn = (_residues(cuda, (3, 3, 3 * t_gsw, p.poly_len))
              for _ in range(2))
    monkeypatch.setattr(fold, "MXU_MIN_COLS", defaultdict(int))
    got = fold.fold_rounds(cts, qp, qn, p)
    monkeypatch.setattr(fold, "MXU_MIN_COLS", {})
    _same(got, fold.fold_rounds(cts, qp, qn, p), "fold_ntt", 3)
    assert kernels.LAUNCHES["fold_contract"] == 3
    assert kernels.LAUNCHES["fold"] == 3


def test_fold_contract_geometry_matches_kernel(cuda):
    """fold.contract_smem, which the engine rule and the CPU model of K8b-2
    read, equals the kernel's own answer at every n1 and t_gsw."""
    lib = kernels.lib()
    for n1 in range(6):
        for t_gsw in range(1, 58):
            assert fold.contract_smem(n1, t_gsw) == \
                lib.spiral_fold_contract_smem(n1, t_gsw), (n1, t_gsw)


def test_fold_g_workspace(cuda, monkeypatch):
    """K8b-1 writes G into the buffer it is given where that holds G (no
    allocation) and into a new tensor where it does not; a fold through a
    server's mxu_workspace, sized by its K8b rounds (round 1 of 8 at
    t_gsw 11: m_out 128), equals K3's."""
    cts = _residues(cuda, (2, 2, 3, 2, 256))
    want = fold.fold_ntt_plain(cts, 11)
    buf = torch.empty(want.numel() + 5, dtype=torch.int32, device="cuda")
    G = fold.fold_ntt(cts, 11, buf)
    _same(G, want, "fold_ntt")
    assert G.data_ptr() == buf.data_ptr()
    G = fold.fold_ntt(cts, 11, buf[:want.numel() - 1])
    _same(G, want, "fold_ntt", 2)
    assert G.data_ptr() != buf.data_ptr()
    from spiral_tpu_torch.params import Params
    p = Params(nu_1=2, nu_2=8, p_db=256, t_gsw=11, t_conv=4, t_exp=8,
               t_exp_right=8)
    buf = fold.mxu_workspace(p, "cuda")
    assert buf.numel() == fold.g_words(11, 128, 6, p.poly_len)
    cts = _residues(cuda, (256, 3, 2, p.poly_len))
    qp, qn = (_residues(cuda, (8, 3, 33, p.poly_len)) for _ in range(2))
    kernels.reset_launches()
    got = fold.fold_rounds(cts, qp, qn, p, g_buf=buf)
    assert kernels.LAUNCHES["fold_ntt"] == 1 and kernels.LAUNCHES["fold"] == 7
    monkeypatch.setattr(fold, "MXU_MIN_COLS", {})
    _same(got, fold.fold_rounds(cts, qp, qn, p), "fold", 15)


def test_factored_fold_outgrows_workspace(cuda, monkeypatch):
    """A factored server's K8b rounds need F times the G of the
    single-database workspace its server makes: those rounds allocate
    their own (K8b-1 still launches) and the F survivors equal K3's."""
    from spiral_tpu_torch.factored import FactoredSpiralServer
    from spiral_tpu_torch.params import Params
    p = Params(nu_1=2, nu_2=8, p_db=256, t_gsw=11, t_conv=4, t_exp=8,
               t_exp_right=8)
    F = 3
    server = FactoredSpiralServer.__new__(FactoredSpiralServer)
    server.params, server._fold_g = p, fold.mxu_workspace(p, "cuda")
    assert server._fold_g.numel() < fold.g_words(11, F * 128, 6, p.poly_len)
    cts = _residues(cuda, (F * 256, 3, 2, p.poly_len))
    qp, qn = (_residues(cuda, (8, 3, 33, p.poly_len)) for _ in range(2))
    got = server.fold(cts, qp, qn)
    assert kernels.LAUNCHES["fold_ntt"] == 2 and got.shape[0] == F
    monkeypatch.setattr(fold, "MXU_MIN_COLS", {})
    _same(got, server.fold(cts, qp, qn), "fold", 6 + 8)


# K9: a cluster of 2 blocks per ct (composition) or 4 (conversion); the
# composition at dim0 256 and 1,024 and a batch of 8 x 256, the conversion
# at nu_2 t_gsw 63 (7 x 9) and 72 (8 x 9) and a batch of 8 x 63, random
# words and every word p - 1 or 0
K9_WORDS = ["random", "p-1", "0"]


def _k9_params(d, nu_2=7, t_gsw=9):
    return dataclasses.replace(preset("spiral_20_256"), poly_len=d,
                               nu_2=nu_2, t_gsw=t_gsw)


def _k9_words(gen, shape, words):
    if words == "random":
        return _residues(gen, shape)
    x = _residues(gen, shape)
    for li, p in enumerate((P_I, B_I)):
        x[..., li, :] = p - 1 if words == "p-1" else 0
    return x


@pytest.mark.parametrize("words", K9_WORDS)
@pytest.mark.parametrize("d", [256, 2048])
@pytest.mark.parametrize("lead, N", [((), 256), ((), 1024), ((8,), 256)])
def test_compose_kernel(cuda, lead, N, d, words):
    cv = _k9_words(cuda, lead + (N, 2, 1, d), words)
    W = _k9_words(cuda, (3, 8, d), words)
    p = _k9_params(d)
    _same(convert.compose_cts(cv, W, p), convert.scal_to_mat_batch(cv, W, p),
          "compose")


@pytest.mark.parametrize("words", K9_WORDS)
@pytest.mark.parametrize("d", [256, 2048])
@pytest.mark.parametrize("lead, nu_2", [((), 7), ((), 8), ((8,), 7)])
def test_convert_kernel(cuda, lead, nu_2, d, words):
    p = _k9_params(d, nu_2=nu_2)
    cv = _k9_words(cuda, lead + (nu_2 * 9, 2, 1, d), words)
    W, V = (_k9_words(cuda, (3, 8, d), words) for _ in range(2))
    g2 = _k9_words(cuda, (3, p.m2, d), words)
    got = convert.convert_cts(cv, W, V, g2, p)
    want = convert.convert_plain(cv, W, V, g2, p)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES["convert"] == 1


def test_k9_batch_as_a_slice(cuda):
    """Both modes take a batch sliced from the expansion's output (B,
    dim0 + nu_2 t_gsw, ...), as the batch path passes it."""
    d, p = 2048, _k9_params(2048)
    cv = _residues(cuda, (8, 256 + 63, 2, 1, d))
    W, V = (_residues(cuda, (3, 8, d)) for _ in range(2))
    g2 = _residues(cuda, (3, p.m2, d))
    first, gsw = cv[:, :256], cv[:, 256:]
    assert not first.is_contiguous() and not gsw.is_contiguous()
    assert torch.equal(convert.compose_cts(first, W, p),
                       convert.scal_to_mat_batch(first, W, p))
    got = convert.convert_cts(gsw, W, V, g2, p)
    want = convert.convert_plain(gsw, W, V, g2, p)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES["compose"] == kernels.LAUNCHES["convert"] == 1


def test_k9_shapes_only(cuda):
    """K9 takes m_conv 4 and d in kernels.REG_NTT_DEGREES only."""
    cv = _residues(cuda, (63, 2, 1, 256))
    W, V = (_residues(cuda, (3, 8, 256)) for _ in range(2))
    for p in (dataclasses.replace(_k9_params(256), t_conv=8),
              _k9_params(64)):
        x = cv[..., :p.poly_len].contiguous()
        w, v = W[..., :p.poly_len].contiguous(), V[..., :p.poly_len]
        g2 = _residues(cuda, (3, p.m2, p.poly_len))
        with pytest.raises(ValueError):
            convert.compose_cts(x, w, p)
        with pytest.raises(ValueError):
            convert.convert_cts(x, w, v.contiguous(), g2, p)
    assert kernels.LAUNCHES["compose"] == kernels.LAUNCHES["convert"] == 0


# tests/test_torch_threefry.py's SEEDS (that file imports jax): negative
# seeds and the int32 edges
THREEFRY_SEEDS = [0, 1, 987654, 2**31 - 1, -1, -(2**31), -123456789]


# one packed query (a ct) and the stream variant's 542 direct cts; a query
# at a time and a batch of 8
@pytest.mark.parametrize("shape", [(1, 1, 1, 2048), (542, 1, 1, 2048)])
@pytest.mark.parametrize("B", [1, 8])
def test_threefry_kernel(cuda, B, shape):
    seeds = THREEFRY_SEEDS + [42]
    batches = [[s] for s in seeds] if B == 1 else [seeds]
    for batch in batches:
        words = seed_words(batch, "cuda")
        got = sampling.uniform_residues_words(words, shape)
        want = sampling.uniform_residues_words_plain(words, shape)
        torch.cuda.synchronize()
        assert got.shape == (B,) + shape[:-1] + (2, shape[-1])
        assert torch.equal(got, want)
    assert kernels.LAUNCHES["threefry"] == len(batches)


def test_threefry_kernel_shapes_only(cuda):
    """K10 takes the (4, 2, B, 1) int64 words uniform_key_words stages."""
    words = seed_words([3, -3], "cuda")
    for bad in (words[:2], words.to(torch.int32), words[..., 0],
                words.transpose(0, 1).contiguous().transpose(0, 1)):
        with pytest.raises(ValueError):
            sampling.uniform_residues_words(bad, (1, 2048))
    with pytest.raises(ValueError):
        sampling.uniform_residues_words(words, (1 << 20, 2048))
    assert kernels.LAUNCHES["threefry"] == 0
