"""The frozen bound formulas equal chip_smoke.py's for K2, K3 and K5 at
the spiral_20_256 shapes (and K2 and K3 at the factored ones)."""
import importlib.util
from pathlib import Path

import pytest

from pirbench import bounds
from pirbench.cell import load_config
from pirbench.reference.scheme import SchemeParams

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke_bound(smoke, nbytes, prods=0, macs=0):
    """check_case's bound in seconds."""
    return max(nbytes / smoke.HBM_BYTES_PER_S,
               max(prods / smoke.INT_PRODUCTS_PER_S,
                   macs / smoke.INT8_MACS_PER_S))


@pytest.mark.parametrize("factor, batch", [(1, 1), (1, 8), (13, 1)])
def test_k2_bound(smoke, factor, batch):
    p = SchemeParams.from_config(load_config("spiral_20_256")["params"])
    d, K, n1 = p.poly_len, p.dim0 * p.n0, p.n1
    m = factor * p.num_per * p.n2
    # check_case's inputs [db (2, d, K, m), query (B, K, n1, 2, d)] and
    # output (2, d, B, n1, m), words of 4 bytes
    nbytes = 4 * (2 * d * K * m + batch * K * n1 * 2 * d +
                  2 * d * batch * n1 * m)
    macs = smoke.K2_MACS_PER_PRODUCT * 2 * d * K * m * batch * n1
    assert bounds.k2_s(p, factor, batch) == smoke_bound(smoke, nbytes, 0,
                                                        macs)


@pytest.mark.parametrize("factor, batch", [(1, 1), (1, 8), (13, 1)])
def test_fold_bound(smoke, factor, batch):
    """K3 (batch 1) and K5 (fold_batch_case: B times the products) round
    by round, as check_case counts each round's inputs and output."""
    p = SchemeParams.from_config(load_config("spiral_20_256")["params"])
    d, n1, n2, t = p.poly_len, p.n1, p.n2, p.t_gsw
    assert smoke.ntt_products(d) == bounds.ntt_products(d)
    total, cts = 0.0, factor * p.num_per
    for _ in range(p.nu_2):
        m_out = cts // 2
        nbytes = 4 * batch * (2 * m_out * n1 * n2 * 2 * d +
                              2 * n1 * t * n1 * 2 * d +
                              m_out * n1 * n2 * 2 * d)
        prods = batch * smoke.fold_products(m_out, n1, n2, t, d)
        assert prods == batch * bounds.fold_products(m_out, n1, n2, t, d)
        total += smoke_bound(smoke, nbytes, prods)
        cts = m_out
    assert bounds.fold_s(p, factor, batch) == pytest.approx(total, rel=1e-12)


def test_peaks_are_chip_smokes(smoke):
    assert (bounds.HBM_BYTES_PER_S, bounds.INT_PRODUCTS_PER_S,
            bounds.INT8_MACS_PER_S, bounds.K2_MACS_PER_PRODUCT) == \
        (smoke.HBM_BYTES_PER_S, smoke.INT_PRODUCTS_PER_S,
         smoke.INT8_MACS_PER_S, smoke.K2_MACS_PER_PRODUCT)
