"""The composition and conversion wrappers on the CPU: the plain versions
run (kernel K9 is CUDA only, tests/test_torch_kernels.py holds it to them
on the card) and no launch is counted."""
import dataclasses

import pytest
import torch

from spiral_tpu_torch import kernels
from spiral_tpu_torch.params import B_I, P_I, PRESETS, preset
from spiral_tpu_torch.server import convert


def _residues(gen, shape):
    return torch.stack([torch.randint(0, p, shape, generator=gen,
                                      dtype=torch.int32) for p in (P_I, B_I)],
                       dim=-2)


@pytest.mark.parametrize("stage", ["compose", "convert"])
def test_k9_wrappers_run_plain_on_cpu(stage):
    p = preset("tiny")
    d, n = p.poly_len, p.further_dims * p.t_gsw
    gen = torch.Generator().manual_seed(3)
    W, V = (_residues(gen, (p.n1, p.n0 * p.m_conv, d)) for _ in range(2))
    kernels.reset_launches()
    if stage == "compose":
        cv = _residues(gen, (2, 5, 2, 1, d))
        got = (convert.compose_cts(cv, W, p),)
        want = (convert.scal_to_mat_batch(cv, W, p),)
    else:
        cv = _residues(gen, (2, n, 2, 1, d))
        g2 = _residues(gen, (p.n1, p.m2, d))
        got = convert.convert_cts(cv, W, V, g2, p)
        gsw = convert.regev_to_gsw_batch(
            cv.unflatten(-5, (p.further_dims, p.t_gsw)), W, V, p).flip(-5)
        pc = torch.tensor([P_I, B_I])[:, None]
        want = (gsw, (g2 - gsw) % pc)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert {"compose", "convert"} <= set(kernels.LAUNCHES)
    assert kernels.LAUNCHES["compose"] == kernels.LAUNCHES["convert"] == 0


def test_k9_takes_the_spiral_presets():
    """Every preset that a SpiralServer serves (the pack presets go to
    PackServer) passes the check a CUDA SpiralServer makes when it is
    made, and another m_conv does not."""
    for name, p in PRESETS.items():
        if "pack" not in name:
            convert.k9_takes(p, p.poly_len)
    p = preset("tiny")
    with pytest.raises(ValueError, match="m_conv 4"):
        convert.k9_takes(dataclasses.replace(p, t_conv=8), p.poly_len)
    with pytest.raises(ValueError, match="d 64"):
        convert.k9_takes(p, 64)
