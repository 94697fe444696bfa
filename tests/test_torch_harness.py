"""The port's harness (spiral_tpu_torch/harness.py) against the JAX one's
pure functions, and its packingcomp figure on the CPU at the tiny
presets; the public parameters' size_bytes at generation against the JAX
clients'."""
import json

import numpy as np
import pytest

from spiral_tpu import harness as jharness
from spiral_tpu.crypto.publicparams import _pub_size
from spiral_tpu.params import PRESETS, preset as jpreset
from spiral_tpu_torch import harness
from spiral_tpu_torch.pack import PackClient
from spiral_tpu_torch.params import preset
from spiral_tpu_torch.pir import SpiralClient

ROWS = [
    {"variant": "spiral", "correct": True, "query_b": 14336, "pub_b": 1,
     "rate": 0.4, "cost_usd": None, "stages_us": {"expansion": 3}},
    {"variant": "spiral_pack", "server_s": 0.0123, "correct": False,
     "extra": [1, 2]},
]
# size_bytes of the JAX clients' setup() at each tiny variant (SpiralClient
# or PackClient, seed 1), the accounting of spiral_tpu/crypto/
# publicparams.py:108-118 and spiral_tpu/pack.py:119-137
JAX_PUB_BYTES = {"tiny": 372736, "tiny_stream": 43008, "tiny_pack": 358400,
                 "tiny_stream_pack": 43008}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_item_resp_bytes_match_jax(name):
    for pack in (False, True):
        assert harness._item_resp_bytes(preset(name), pack) == \
            jharness._item_resp_bytes(jpreset(name), pack)


def test_get_cost_matches_jax():
    for us, nbytes in ((1.0, 0), (12345.6, 21504), (3e7, 102404)):
        assert harness.get_cost(us, nbytes, 1.20) == \
            jharness.get_cost(us, nbytes)
        assert harness.get_cost(us, nbytes, None) is None


@pytest.mark.parametrize("fmt", ["plain", "latex"])
def test_render_table_matches_jax(fmt):
    assert harness.render_table(ROWS, fmt) == jharness.render_table(ROWS, fmt)
    assert harness.render_table([], fmt) == ""


def test_results_round_trip(tmp_path):
    path = harness.save_results("ubench", ROWS, str(tmp_path))
    assert path == str(tmp_path / "ubench_results.json")
    assert harness.load_results("ubench", str(tmp_path)) == ROWS
    with pytest.raises(FileNotFoundError):
        harness.load_results("streaming", str(tmp_path))


def _jax_pub_bytes(name: str, pub) -> int:
    """JAX's own accounting on the port's shapes: _pub_size of each key
    matrix (publicparams.py:108-118), or PackClient.setup's sums
    (pack.py:119-137)."""
    p = jpreset(name)
    d = p.poly_len
    exp = [_pub_size(w.shape[:2], d) for w in
           (pub.W_exp_left or []) + (pub.W_exp_right or [])]
    if "pack" in name:
        size = p.out_n * (p.out_n + 1) * p.m_conv * d * 56 // 8
        return size + (sum(exp) + 2 * 2 * p.m_conv * d * 56 // 8
                       if exp else 0)
    size = _pub_size(pub.W_conv.shape[:2], d) + sum(exp)
    return size + (0 if p.direct_upload_rest else
                   _pub_size(pub.V.shape[:2], d))


@pytest.mark.parametrize("name", sorted(JAX_PUB_BYTES))
def test_public_param_size_bytes_match_jax(name):
    Client = PackClient if "pack" in name else SpiralClient
    pub = Client(preset(name), seed=1, device="cpu").setup()
    assert pub.size_bytes == JAX_PUB_BYTES[name] == _jax_pub_bytes(name, pub)


def _jax_query_bytes(variant: str, p) -> int:
    """The JAX clients' query size_bytes: Params.query_size_bytes() for
    Spiral (crypto/query.py:185, :194), one poly for the packed pack query
    (pack.py:167) and dim0 scalars plus a pair a GSW digit value for
    SpiralStreamPack (pack.py:187)."""
    if variant == "spiralstreampack":
        return (p.dim0 + 2 * p.further_dims * p.t_gsw) * p.bytes_per_poly
    if variant == "spiralpack":
        return p.bytes_per_poly
    return p.query_size_bytes()


def test_packingcomp_tiny(tmp_path, monkeypatch, capsys):
    """The figure at the tiny presets through main, into the default
    results directory, results_torch/ (never the JAX harness's results/):
    four correct rows whose query, public-param and response bytes are
    the JAX package's, and no cost without a price for the card."""
    monkeypatch.chdir(tmp_path)
    assert harness.main(["packingcomp", "--tiny", "--device", "cpu"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert harness.RESULTS_DIR != jharness.RESULTS_DIR
    assert not (tmp_path / jharness.RESULTS_DIR).exists()
    assert harness.load_results("packingcomp") == rows
    assert [r["variant"] for r in rows] == list(harness.VARIANTS)
    scen = jharness.scenario_params(True)
    for r in rows:
        p = scen[r["variant"]]
        pack = "pack" in r["variant"]
        name = {"spiral": "tiny", "spiralstream": "tiny_stream",
                "spiralpack": "tiny_pack",
                "spiralstreampack": "tiny_stream_pack"}[r["variant"]]
        assert r["correct"] is True
        assert r["query_b"] == _jax_query_bytes(r["variant"], p)
        assert r["pub_b"] == JAX_PUB_BYTES[name]
        assert r["resp_b"] == jharness._item_resp_bytes(p, pack)[1]
        assert r["cost_usd"] is None
        assert r["server_s"] > 0 and np.isfinite(r["tput_MB_s"])
