"""Exact modulus switching of CRT residues on the server's device
(counterpart of spiral_tpu/core/rescale.py rescale_residues_device).  The
client's decode needs no host-side rescale (crypto/decode.py)."""
from __future__ import annotations

import torch

from ..params import Q
from ..arith.crt import lift_pair


def rescale_residues_device(x_p, x_b, out_mod: int):
    """round(v * out_mod / Q) mod out_mod for v the lift of (x_p, x_b),
    as floor((v*c + Q//2) / Q) (Q is odd, so no ties).

    v*c overflows int64, so the quotient is built bit by bit over c
    (Horner): with v*c' = y*Q + r (r < Q), doubling c' and adding a bit
    keeps r < 3Q < 2^58.  Bit-identical to the JAX multiword version.
    """
    c = int(out_mod)
    assert 0 < c < (1 << 31)
    v = lift_pair(x_p, x_b)
    y = torch.zeros_like(v)
    r = torch.zeros_like(v)
    for bit in range(c.bit_length() - 1, -1, -1):
        r = 2 * r + ((c >> bit) & 1) * v
        y = 2 * y
        for _ in range(2):
            over = r >= Q
            r = torch.where(over, r - Q, r)
            y = y + over.long()
    r = r + Q // 2
    y = y + (r >= Q).long()
    return (y % c).to(torch.int32)
