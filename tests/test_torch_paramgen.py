"""The port's parameter generation (spiral_tpu_torch/paramgen) against the
JAX package's on the same inputs: the noise model, the sweep and its
artifact, the error analysis and the LUT helpers.  Everything is exact
(==) except the proxy fit, which is held to its stated relative
tolerance.  The committed H100 LUT is checked for its tag, its card and
its correctness flags; one tiny measurement and one tiny error collection
run on the CPU."""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
from scipy.optimize import nnls

from spiral_tpu.params import PRESETS as JPRESETS, Params as JParams
from spiral_tpu.paramgen import analyze_err as janalyze
from spiral_tpu.paramgen import build_lut as jbuild_lut
from spiral_tpu.paramgen import noise as jnoise
from spiral_tpu.paramgen import sweep as jsweep
from spiral_tpu_torch.params import PRESETS, Params, preset
from spiral_tpu_torch.paramgen import analyze_err, build_lut, noise, search
from spiral_tpu_torch.paramgen import sweep

PKG = pathlib.Path(build_lut.__file__).resolve().parent.parent
# the least and the largest analyze_deviation ratio (measured / proxy)
# over the committed H100 LUT, as PERF.md section 6 (PR 12) states them
WORST_RATIO = (0.817, 1.443)
# the proxy's constants are written to 4 significant digits
FIT_RTOL = 5e-4


def _outcome(fn, *args):
    """fn's result, or the type of the exception it raised."""
    try:
        return fn(*args)
    except (AssertionError, ValueError, OverflowError, KeyError) as e:
        return type(e)


def _noise_results(mod, p, pack: bool):
    s_e = (mod.noise_variance_highrate if pack else mod.noise_variance)(p)
    n = p.out_n if pack else p.n0
    return (s_e, mod.p_err_bits(p.p_db, p.arb_qprime, s_e, n=n,
                                d=p.poly_len),
            mod.min_qprime_bits(p, s_e, n=n))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_noise_model_equals_jax_at_presets(name):
    for pack in (False, True):
        assert _outcome(_noise_results, noise, preset(name), pack) == \
            _outcome(_noise_results, jnoise, JPRESETS[name], pack)
    assert noise.get_real_p(preset(name).p_db) == \
        jnoise.get_real_p(JPRESETS[name].p_db)


def _artifact_params(cls, art, i):
    variant = int(art["variant"][i])
    direct = variant % 2 == 1
    nu_1, nu_2 = int(art["nu_1"][i]), int(art["nu_2"][i])
    t_gsw = int(art["t_gsw"][i])
    return variant >= 2, cls(
        nu_1=nu_1, nu_2=nu_2, p_db=1 << int(art["p_log"][i]),
        q_prime_bits=int(art["qp_bits"][i]), t_gsw=t_gsw,
        t_conv=int(art["t_conv"][i]), t_exp=int(art["t_exp"][i]),
        t_exp_right=56, out_n=int(art["out_n"][i]),
        query_elems_first=(1 << nu_1) if direct else 1,
        query_elems_rest=nu_2 * t_gsw if direct else 0)


def test_noise_model_equals_jax_on_artifact_rows():
    """200 rows of the sweep artifact, drawn with default_rng(0): every
    noise result equal to the last bit, at the row's q' and at 14 bits."""
    art = jsweep.load_artifact()
    idx = np.random.default_rng(0).choice(len(art["variant"]), size=200,
                                          replace=False)
    for i in idx:
        pack, p = _artifact_params(Params, art, i)
        _, jp = _artifact_params(JParams, art, i)
        assert _noise_results(noise, p, pack) == \
            _noise_results(jnoise, jp, pack)
        s_e = noise.noise_variance(p)
        assert _outcome(noise.p_err_bits, p.p_db, 12289, s_e) == \
            _outcome(jnoise.p_err_bits, jp.p_db, 12289, s_e)


def test_spaces_equal_jax():
    spaces, jspaces = sweep._spaces(), jsweep._spaces()
    assert spaces.keys() == jspaces.keys()
    for variant, sp in spaces.items():
        assert {k: list(v) for k, v in sp.items()} == \
            {k: list(v) for k, v in jspaces[variant].items()}


# one (variant, p_log, nu_1, nu_2, out_n) group of each variant that keeps
# rows: regular, streaming, highrate, highrate streaming
GROUPS = [(0, 9, 7, 6, 2), (1, 11, 8, 12, 2), (2, 2, 7, 6, 4),
          (3, 20, 8, 12, 4)]


@pytest.mark.parametrize("group", GROUPS)
def test_eval_group_equals_jax(group):
    """The same Pareto rows, in order."""
    sp = sweep._spaces()[group[0]]
    job = group + (tuple(sp["t_gsw"]), tuple(sp["t_conv"]),
                   tuple(sp["t_exp"]))
    rows = sweep._eval_group(job)
    assert rows and rows == jsweep._eval_group(job)


def test_artifact_equals_jax_column_by_column():
    art, jart = sweep.load_artifact(), jsweep.load_artifact()
    assert sweep.DEFAULT_OUT.resolve().parent == PKG / "paramgen"
    assert sweep.DEFAULT_OUT.resolve() != jsweep.DEFAULT_OUT.resolve()
    assert sorted(art) == sorted(jart) and len(art["variant"]) == 25745
    for k in jart:
        assert art[k].dtype == jart[k].dtype, k
        assert np.array_equal(art[k], jart[k]), k


def test_analyze_err_functions_equal_jax():
    rng = np.random.default_rng(3)
    errs = rng.normal(0, 2.0 ** 44, size=4000)
    p = preset("tiny")
    for fn in ("log2_variance", "empirical_subgaussian_width"):
        assert getattr(analyze_err, fn)(errs) == getattr(janalyze, fn)(errs)
    assert analyze_err.extrapolate_p_err(errs, p) == \
        janalyze.extrapolate_p_err(errs, JPRESETS["tiny"])
    bins = [2 ** i for i in np.arange(40, 50, 0.5)]
    assert analyze_err.modulus_cutoff(errs, bins, 256) == \
        janalyze.modulus_cutoff(errs, bins, 256)
    assert analyze_err.rate_table(errs, 256) == janalyze.rate_table(errs, 256)
    assert analyze_err.extend_subg(0.01, 2.0 ** 47, 256) == \
        janalyze.extend_subg(0.01, 2.0 ** 47, 256)
    # error_samples on a small random ct, secret and record
    d, n0, n1, n2 = 16, 2, 3, 2
    small = dataclasses.replace(p, poly_len=d)
    ct = rng.integers(0, 2 ** 62, size=(n1, n2, d)).astype(object) % \
        analyze_err.Q
    S = rng.integers(-4, 5, size=(n0, n1, d))
    pt = rng.integers(0, 256, size=(n0, n2, d))
    mine = analyze_err.error_samples(ct, S, pt, small)
    theirs = janalyze.error_samples(ct, S, pt, dataclasses.replace(
        JPRESETS["tiny"], poly_len=d))
    assert mine.tolist() == theirs.tolist()


def test_analyze_err_main_file_mode_equals_jax(tmp_path, capsys):
    errs = np.random.default_rng(4).normal(0, 2.0 ** 45, size=3000)
    path = tmp_path / "errs.txt"
    path.write_text(" ".join(str(int(e)) for e in errs))
    assert analyze_err.main(["256", str(path)]) == 0
    mine = capsys.readouterr().out
    assert janalyze.main(["256", str(path)]) == 0
    assert mine == capsys.readouterr().out


def test_collect_errors_below_model_on_cpu():
    """A tiny query's pre-modswitch error, from final_ciphertext lifted mod
    Q: its log2 variance sits below the analytical bound, as
    tests/test_noise_empirical.py checks for the JAX server."""
    errs = analyze_err.collect_errors("tiny", seeds=1, device="cpu")
    p = preset("tiny")
    assert errs.shape == (p.n0 * p.n2 * p.poly_len,)
    measured = analyze_err.log2_variance(errs)
    assert 0 < measured < math.log2(noise.noise_variance(p))
    assert analyze_err.extrapolate_p_err(errs, p) < -30


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_lut_key_equals_jax(name):
    assert build_lut.lut_key(preset(name)) == \
        jbuild_lut.lut_key(JPRESETS[name])


@pytest.mark.parametrize("spec", ["8:6:9", "9:7:9", "8:7:10", "9:8:11",
                                  "2:2:8"])
def test_grid_params_equal_jax(spec):
    mine, theirs = build_lut.grid_params(spec), jbuild_lut.grid_params(spec)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_default_paths_inside_port():
    for path in (build_lut.DEFAULT_LUT, sweep.DEFAULT_OUT):
        assert path.resolve().parent == PKG / "paramgen"
        assert path.exists()
    assert build_lut.DEFAULT_LUT.name == "h100_lut.json"


def test_measure_tiny_on_cpu(tmp_path, capsys):
    """build_lut's main at tiny on the CPU writes one correct entry with
    the port's tag to --out and leaves the committed LUT alone."""
    before = build_lut.DEFAULT_LUT.read_bytes()
    out = tmp_path / "lut.json"
    assert build_lut.main(["--presets", "tiny", "--out", str(out),
                           "--device", "cpu", "--trials", "1"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
        {"entries": 1, "out": str(out)}
    lut = json.loads(out.read_text())
    entry = lut[build_lut.lut_key(preset("tiny"))]
    assert entry["is_corr"] is True
    assert entry["kernel_version"] == build_lut.KERNEL_VERSION
    assert entry["card"] == "cpu" and entry["variant"] == "spiral"
    assert Params(**entry["params"]) == preset("tiny")
    assert entry["server_s"] > 0 and entry["query_sz"] == 1792
    assert build_lut.DEFAULT_LUT.read_bytes() == before


def _h100_entries():
    return json.loads(build_lut.DEFAULT_LUT.read_text())


def test_committed_lut_is_current_and_measured_on_the_card():
    """Every entry decoded, carries the current KERNEL_VERSION (a stale tag
    makes the selection treat every entry as unmeasured) and names the
    card it ran on; its key is the params' key."""
    lut = _h100_entries()
    assert len(lut) >= 8
    assert build_lut.KERNEL_VERSION != jbuild_lut.KERNEL_VERSION
    for key, e in lut.items():
        assert e["is_corr"] is True, key
        assert e["kernel_version"] == build_lut.KERNEL_VERSION, key
        assert "H100" in e["card"] and e["card"].endswith(" W"), key
        assert build_lut.lut_key(Params(**e["params"])) == key
        assert e["pipelined_s"] > 0 and e["server_s"] > 0
    for name in ("spiral_20_256", "spiralstream_20_256",
                 "spiralpack_20_256", "spiralstreampack_20_256"):
        assert build_lut.lut_key(preset(name)) in lut, name


def _fit_rows():
    keys, terms, times, first_dim = [], [], [], []
    for key, e in _h100_entries().items():
        if e["is_corr"] and e["kernel_version"] == build_lut.KERNEL_VERSION:
            keys.append(key)
            terms.append(search.proxy_terms(Params(**e["params"]),
                                            "pack" in e["variant"]))
            times.append(e["pipelined_s"])
            first_dim.append(e["stages_us"]["first_dim"] * 1e-6)
    return keys, np.array(terms), np.array(times), np.array(first_dim)


def test_h100_proxy_is_the_lut_fit():
    """The proxy's constants are the fit search.py describes, on the
    committed LUT's correct entries: the database stream the least-squares
    slope of the first-dim stage time on the bytes streamed, the rest the
    non-negative least-squares fit of pipelined_s less that stream (each
    column scaled to unit norm), written to 4 significant digits
    (FIT_RTOL); FITTED_ON names those entries and CARD their card."""
    keys, A, y, first_dim = _fit_rows()
    db = A[:, 2]
    slope = np.linalg.lstsq(np.stack([np.ones_like(db), db], 1), first_dim,
                            rcond=None)[0][1]
    rest = A[:, [0, 1, 3, 4, 5]]
    norm = np.linalg.norm(rest, axis=0)
    coef = nnls(rest / norm, y - slope * db)[0] / norm
    fit = (coef[0], coef[1], slope, coef[2], coef[3], coef[4])
    mine = (search.SERVE_FLOOR_S, search.UPLOAD_S_PER_BYTE,
            search.DB_S_PER_BYTE, search.EXP_S_PER_POLY,
            search.CONV_S_PER_POLY, search.FOLD_S_PER_POLY)
    for c, f in zip(mine, fit):
        assert c == pytest.approx(f, rel=FIT_RTOL, abs=1e-30)
    assert sorted(search.FITTED_ON) == sorted(keys)
    assert {e["card"] for e in _h100_entries().values()} == {search.CARD}


def test_analyze_deviation_within_stated_bound():
    rows = build_lut.analyze_deviation(_h100_entries())
    assert len(rows) == len(_h100_entries())
    for r in rows:
        assert r["is_corr"] and not r["stale_kernel"]
        assert WORST_RATIO[0] <= r["ratio"] <= WORST_RATIO[1], r
