"""Batched negacyclic NTT over both CRT moduli, in the JAX ``mxu`` slot
order (counterpart of spiral_tpu/arith/ntt.py and ntt_mxu.py; the
module functions ``forward``/``inverse`` play the role of CrtNtt's).

``forward``/``inverse`` take int32 words (..., 2, d), read as residues
mod (P_I, B_I) along the limb axis.  On a CPU tensor they run the plain
radix-2 version below; on a CUDA tensor they launch kernel K1
(csrc/ntt.cu), which replaces the Pallas NTT
(spiral_tpu/arith/ntt_pallas.py CrtNttPallas._run).  K1 runs the register
core of csrc/ntt_reg.cuh: each block loads one limb's merged twiddles once
and its teams of d/8 threads transform that limb's polys two at a time,
rows read and written coalesced.  It is built for d in
``kernels.REG_NTT_DEGREES`` only.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from .. import kernels
from .mod import add_mod, p_col, sub_mod
from .tables import ntt_tables


@lru_cache(maxsize=None)
def _tables(d: int, device: str):
    """The plain version's tables on `device`, then the (9, d) int32
    table the CUDA kernels read (arith/tables.py packed())."""
    tb = ntt_tables(d)
    as_t = lambda a: torch.from_numpy(a).to(device)
    return (as_t(tb.twist), as_t(tb.untwist), as_t(tb.omega),
            as_t(tb.omega_inv), as_t(tb.pos_of_slot), as_t(tb.slot_of_pos),
            as_t(tb.packed()))


def kernel_table(d: int, device) -> torch.Tensor:
    """The packed table of the register-NTT kernels at degree d on
    `device`."""
    return _tables(d, str(device))[-1]


def forward_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain forward NTT: psi-twist, radix-2 decimation in frequency
    (natural in, bit-reversed out), then the gather into mxu order."""
    d = x.shape[-1]
    L = d.bit_length() - 1
    twist, _, omega, _, pos_of_slot, _, _ = _tables(d, str(x.device))
    p = p_col(x.device)
    a = x.long() * twist % p
    p3 = p[:, :, None]
    for s in range(L):
        t = d >> (s + 1)
        w = omega[:, ::1 << s][:, None, :t]           # (2, 1, t)
        v = a.reshape(a.shape[:-1] + (1 << s, 2, t))
        l, r = v[..., 0, :], v[..., 1, :]
        a = torch.stack([add_mod(l, r, p3), sub_mod(l, r, p3) * w % p3],
                        dim=-2).reshape(a.shape)
    return a[..., pos_of_slot].to(torch.int32)


def inverse_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain inverse NTT: mxu order back to bit-reversed positions, radix-2
    decimation in time, then the d^{-1} psi^{-i} untwist."""
    d = x.shape[-1]
    L = d.bit_length() - 1
    _, untwist, _, omega_inv, _, slot_of_pos, _ = _tables(d, str(x.device))
    p = p_col(x.device)
    p3 = p[:, :, None]
    a = x.long()[..., slot_of_pos]
    for s in range(L - 1, -1, -1):
        t = d >> (s + 1)
        w = omega_inv[:, ::1 << s][:, None, :t]
        v = a.reshape(a.shape[:-1] + (1 << s, 2, t))
        bw = v[..., 1, :] * w % p3
        a = torch.stack([add_mod(v[..., 0, :], bw, p3),
                         sub_mod(v[..., 0, :], bw, p3)],
                        dim=-2).reshape(a.shape)
    return (a * untwist % p).to(torch.int32)


def _launch(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    d = x.shape[-1]
    kernels.require(x, x.shape, "ntt input")
    if x.shape[-2] != 2 or d not in kernels.REG_NTT_DEGREES:
        raise ValueError(f"ntt kernel takes (..., 2, d), d in "
                         f"{kernels.REG_NTT_DEGREES}; got {tuple(x.shape)}")
    out = torch.empty_like(x)
    n_polys = x.numel() // d
    if n_polys:
        lib = kernels.lib()
        kernels.check(lib.spiral_ntt(
            x.data_ptr(), out.data_ptr(),
            kernel_table(d, x.device).data_ptr(), n_polys, d,
            int(inverse), kernels.stream()), "spiral_ntt")
        kernels.LAUNCHES["ntt"] += 1
    return out


def forward(x: torch.Tensor) -> torch.Tensor:
    if kernels.on_cpu(x):
        return forward_plain(x)
    return _launch(x.contiguous(), inverse=False)


def inverse(x: torch.Tensor) -> torch.Tensor:
    if kernels.on_cpu(x):
        return inverse_plain(x)
    return _launch(x.contiguous(), inverse=True)
