"""The port's selection (paramgen/search.py), its CLIs (select_params.py,
output_params.py, run_scheme.py) and the harness's selection figures
against the JAX package's on the same inputs.  Rate-mode selection is
exact arithmetic and must be equal as it stands.  Throughput ranking
differs only in its data (the H100 LUT and the proxy fitted to it
against the TPU LUT and the TPU proxy), so with the port's proxy, LUT
and tag patched to the JAX ones the selections must be equal too.  Every
comparison is exact (==)."""
import dataclasses
import json
import subprocess
import sys
import types

import pytest

from spiral_tpu import harness as jharness
from spiral_tpu import output_params as joutput
from spiral_tpu import run_scheme as jrun
from spiral_tpu import select_params as jcli
from spiral_tpu.paramgen import build_lut as jbuild_lut
from spiral_tpu.paramgen import search as jsearch
from spiral_tpu_torch import harness, output_params, run_scheme
from spiral_tpu_torch import select_params as cli
from spiral_tpu_torch.paramgen import build_lut, search
from test_run_scheme import FASTPIR_OUT, ONIONPIR_OUT, SEALPIR_OUT

VARIANTS = {"spiral": {}, "stream": {"direct_upload": True},
            "pack": {"pack": True},
            "streampack": {"direct_upload": True, "pack": True}}
RATE_GRID = [(log_n, item, v) for log_n in (14, 20, 24)
             for item in (256, 30_000, 100_000, 1_000_000)
             for v in VARIANTS]
CAPPED = [(14, 100_000, {"max_total_query_bytes": 20_000_000}),
          (20, 30_000, {"direct_upload": True,
                        "max_query_bytes": 33_000_000})]


@pytest.fixture
def jax_data(monkeypatch):
    """The port's selection ranked on the JAX package's data: its proxy,
    its LUT and its LUT's tag."""
    monkeypatch.setattr(search, "h100_cost_proxy", jsearch.tpu_cost_proxy)
    monkeypatch.setattr(build_lut, "load_lut",
                        lambda path=None: jbuild_lut.load_lut())
    monkeypatch.setattr(build_lut, "KERNEL_VERSION",
                        jbuild_lut.KERNEL_VERSION)


def _selected(mod, *args, **kw):
    try:
        s = mod.select_params(*args, **kw)
    except ValueError as e:
        return str(e)
    return (dataclasses.asdict(s.params), s.factor, s.p_err_bits, s.cost,
            s.measured)


@pytest.mark.parametrize("log_n,item,variant", RATE_GRID)
def test_rate_selection_equals_jax(log_n, item, variant):
    kw = dict(VARIANTS[variant], optimize_for="rate")
    assert _selected(search, log_n, item, **kw) == \
        _selected(jsearch, log_n, item, **kw)


@pytest.mark.parametrize("log_n,item,kw", CAPPED)
def test_capped_rate_selection_equals_jax(log_n, item, kw):
    kw = dict(kw, optimize_for="rate")
    assert _selected(search, log_n, item, **kw) == \
        _selected(jsearch, log_n, item, **kw)


def test_live_enumeration_equals_jax(jax_data):
    """d = 256 has no artifact: the live model enumeration, pinned to
    nu = (6, 4), in both rankings."""
    for opt in ("rate", ""):
        kw = dict(d=256, set_dims=(6, 4), optimize_for=opt)
        assert _selected(search, 12, 256, **kw) == \
            _selected(jsearch, 12, 256, **kw)


TPUT_CASES = [(20, 256, v) for v in VARIANTS] + [
    (14, 100_000, "spiral"), (14, 30_000, "pack"),
    (14, 2_000_000_000, "stream"), (14, 2_000_000_000, "streampack")]


@pytest.mark.parametrize("log_n,item,variant", TPUT_CASES)
def test_tput_ranking_on_jax_data_equals_jax(jax_data, log_n, item,
                                             variant):
    kw = dict(VARIANTS[variant])
    if item == 2_000_000_000:
        kw["max_query_bytes"] = 33_000_000
    assert _selected(search, log_n, item, **kw) == \
        _selected(jsearch, log_n, item, **kw)


def test_tput_ranking_on_jax_data_picks_the_tpu_lut_entry(jax_data):
    s = search.select_params(14, 100_000)
    assert (s.params.nu_1, s.params.nu_2, s.params.t_gsw) == (8, 7, 9)
    assert (s.factor, s.cost, s.measured) == (13, 0.4342, True)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_committed_lut_entries_rank_as_measured(variant):
    """On the committed H100 LUT each variant's (20, 256) selection is a
    measured entry: a tag other than the entries' would leave every entry
    unmeasured and the ranking to the proxy."""
    s = search.select_params(20, 256, **VARIANTS[variant])
    assert s.measured and s.factor == 1
    entry = build_lut.load_lut()[build_lut.lut_key(s.params)]
    assert s.cost == entry["pipelined_s"]


def _jax_cli(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["select_params"] + argv)
    assert jcli.main() == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["20", "256", "--dry-run", "--optimize-for", "rate"],
    ["14", "100000", "--dry-run", "--optimize-for", "rate"],
    ["20", "256", "--pack", "--dry-run", "--optimize-for", "rate"],
    ["14", "100000", "--dry-run", "--optimize-for", "rate",
     "--max-total-query-size", "20000000"]])
def test_cli_rate_dry_run_prints_jax_json(monkeypatch, capsys, argv):
    assert cli.main(argv + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    assert mine == _jax_cli(monkeypatch, capsys, argv)
    assert json.loads(mine)["params"]


@pytest.mark.parametrize("argv", [
    ["20", "256", "--dry-run"], ["14", "100000", "--dry-run"],
    ["20", "256", "--direct-upload", "--pack", "--dry-run"]])
def test_cli_dry_run_on_jax_data_prints_jax_json(jax_data, monkeypatch,
                                                 capsys, argv):
    assert cli.main(argv) == 0
    mine = capsys.readouterr().out
    assert mine == _jax_cli(monkeypatch, capsys, argv)


def test_cli_run_on_cpu_decodes(capsys):
    """The run path at a d = 256 shape on the CPU: the decode is checked
    and the stage keys are the reference's."""
    assert cli.main(["8", "256", "--poly-len", "256", "--set-dims", "3",
                     "3", "--optimize-for", "rate", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["is_corr"] is True
    assert {"total_us", "exp_us", "conv_us", "fdim_us", "fold_us",
            "pack_us", "tput_mb_s"} <= set(out)


ROWS = [{"variant": "spiral", "params": {"nu_1": 8}, "rate": 0.4},
        {"system": "spiralstream", "params": {"nu_1": 9}},
        {"system": "sealpir", "available": False}]


@pytest.mark.parametrize("schemes,params_only", [
    ([], False), ([], True), (["spiralstream"], False), (["sealpir"], True)])
def test_output_params_equal_jax(schemes, params_only):
    assert output_params.process_rows(ROWS, schemes, params_only) == \
        joutput.process_rows(ROWS, schemes, params_only)


def test_output_params_main_equals_jax(tmp_path, monkeypatch, capsys):
    path = tmp_path / "limits_results.json"
    path.write_text(json.dumps(ROWS))
    argv = ["--params", "--pretty", str(path), "spiral"]
    assert output_params.main(argv) == 0
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["output_params"] + argv)
    assert joutput.main() == 0
    assert mine == capsys.readouterr().out


@pytest.mark.parametrize("system,out", [("sealpir", SEALPIR_OUT),
                                        ("fastpir", FASTPIR_OUT),
                                        ("onionpir", ONIONPIR_OUT)])
def test_run_scheme_analyzers_equal_jax(system, out):
    for args in ((20, 256, 1, False), (20, 6144, 2, False),
                 (20, 3072, 1, True)):
        assert run_scheme._ANALYZERS[system](out, *args) == \
            jrun._ANALYZERS[system](out, *args)


def test_run_scheme_tables_nopriv_and_unavailable(monkeypatch):
    for name in ("SYSTEMS", "MAX_ITEM_BYTES", "OTHER_PP_SZ", "BIN_ENV"):
        assert getattr(run_scheme, name) == getattr(jrun, name)
    assert run_scheme.run_system("nopriv", 20, 256) == \
        jrun.run_system("nopriv", 20, 256)
    for s in run_scheme.OTHER_PP_SZ:
        assert run_scheme.get_pp_size(s) == jrun.get_pp_size(s)
    assert run_scheme.get_factor(100000, 30720) == \
        jrun.get_factor(100000, 30720)
    monkeypatch.delenv("SEALPIR_BIN", raising=False)
    with pytest.raises(run_scheme.SystemUnavailable) as mine:
        run_scheme.run_system("sealpir", 20, 256)
    with pytest.raises(jrun.SystemUnavailable) as theirs:
        jrun.run_system("sealpir", 20, 256)
    assert str(mine.value) == str(theirs.value)


def test_run_scheme_spiral_runs_the_port_cli(monkeypatch, capsys):
    """_run_spiral starts the port's select_params (never the JAX one),
    passes --device on, and reads its last JSON line as JAX does."""
    line = json.dumps({"dbsize": 100, "fdim_us": 3, "fold_us": 2,
                       "resp_sz": 7, "item_sz": 1, "param_sz": 5,
                       "params": {}, "query_sz": 9, "total_us": 11})
    seen = []

    def fake(cmd, text):
        seen.append(cmd)
        return "noise\n" + line + "\n"
    monkeypatch.setattr(subprocess, "check_output", fake)
    res = run_scheme.run_system_tr("spiralstream-pack", 20, 1,
                                   streaming=True,
                                   cmd_extras=["--device", "cpu"])
    assert seen[0][1:] == ["-m", "spiral_tpu_torch.select_params", "20",
                           "1", "--direct-upload", "--pack", "--device",
                           "cpu"]
    assert res["tput"] == 20.0 and res["from_trials"] == 1
    assert run_scheme.main(["spiral", "20", "256", "--device", "cpu"]) == 0
    assert seen[1][-2:] == ["--device", "cpu"]
    assert json.loads(capsys.readouterr().out)["total_us"] == 11


def test_table_competitor_cells_unavailable(monkeypatch):
    for var in ("SEALPIR_BIN", "FASTPIR_BIN", "ONIONPIR_BIN"):
        monkeypatch.delenv(var, raising=False)
    spiral_rows = [{"variant": "spiral", "correct": True}]
    monkeypatch.setattr(harness, "fig_packingcomp",
                        lambda args: [dict(r) for r in spiral_rows])
    args = types.SimpleNamespace(tiny=True, trials=1, usd_per_hour=None)
    rows = harness.fig_table(args)
    assert [r["variant"] for r in rows] == \
        ["spiral", "sealpir", "fastpir", "onionpir", "nopriv"]
    assert all(r["scenario"] == "tiny" for r in rows)
    assert [r["available"] for r in rows[1:]] == [False] * 3 + [True]
    assert rows[-1] == {"variant": "nopriv", "scenario": "tiny",
                        "available": True, "query_b": 0, "pub_b": 0,
                        "resp_b": 256, "rate": 1.0, "server_s": 0.0,
                        "cost_usd": None}


@pytest.mark.parametrize("system", list(harness.VARIANTS))
def test_dryrun_cell_rate_equals_jax(system):
    assert harness._dryrun_cell(system, 14, 100_000, optimize_for="rate") \
        == jharness._dryrun_cell(system, 14, 100_000, optimize_for="rate")


@pytest.mark.parametrize("figure", ["limits", "application"])
def test_figures_on_jax_data_equal_jax(jax_data, figure):
    args = types.SimpleNamespace(max_query_mb=33)
    mine = harness.FIGURES[figure](args)
    assert mine == jharness.FIGURES[figure](args)
    assert len(mine) == {"limits": 6, "application": 8}[figure]
