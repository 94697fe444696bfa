"""First-dimension multiply, the stage that streams the database
(counterpart of spiral_tpu/server/firstdim.py).

out[limb, z, g, col] = sum_k Q[k, g, limb, z] * DB[limb, z, k, col] mod p

On a CUDA tensor ``multiply_query_by_db`` launches kernel K2
(csrc/firstdim.cu), which replaces the Pallas first-dim kernel
(spiral_tpu/server/firstdim.py multiply_query_by_db_fused); on the CPU it
runs ``multiply_plain``.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..arith.mod import p_col
from ..core.poly import MAC_CHUNK

# NTT slots per step of the plain multiply, bounding its int64 temporaries
SLOT_CHUNK = 64


def reorient_query(cts: torch.Tensor) -> torch.Tensor:
    """dim0 matrix-Regev cts (dim0, n1, n0, 2, d) -> (K = dim0*n0, n1, 2, d)."""
    dim0, n1, n0 = cts.shape[:3]
    return cts.transpose(1, 2).reshape(dim0 * n0, n1, *cts.shape[3:])


def multiply_plain(db: torch.Tensor, query_k: torch.Tensor) -> torch.Tensor:
    """db (2, d, K, m), query_k (K, n1, 2, d) -> (2, d, n1, m), as broadcast
    multiplies summed over at most MAC_CHUNK k at a time, SLOT_CHUNK NTT
    slots at a time."""
    crt, d, K, m = db.shape
    q = query_k.permute(2, 3, 0, 1).long()             # (2, d, K, n1)
    p = p_col(db.device)[:, :, None, None]             # (2, 1, 1, 1)
    out = []
    for z0 in range(0, d, SLOT_CHUNK):
        zs = slice(z0, z0 + SLOT_CHUNK)
        acc = 0
        for k0 in range(0, K, MAC_CHUNK):
            ks = slice(k0, k0 + MAC_CHUNK)
            prod = (q[:, zs, ks, :, None] *
                    db[:, zs, ks, None, :].long()).sum(dim=2)
            acc = (acc + prod % p) % p
        out.append(acc)
    return torch.cat(out, dim=1).to(torch.int32)


def multiply_query_by_db(db: torch.Tensor, query_k: torch.Tensor
                         ) -> torch.Tensor:
    if kernels.on_cpu(db, query_k):
        return multiply_plain(db, query_k)
    crt, d, K, m = db.shape
    n1 = query_k.shape[1]
    kernels.require(db, (2, d, K, m), "firstdim db")
    q = query_k.permute(2, 3, 0, 1).contiguous()        # (2, d, K, n1)
    kernels.require(q, (2, d, K, n1), "firstdim query")
    if n1 > 4:
        raise ValueError(f"firstdim kernel takes n1 <= 4, got {n1}")
    out = torch.empty((2, d, n1, m), dtype=torch.int32, device=db.device)
    kernels.check(kernels.lib().spiral_firstdim(
        db.data_ptr(), q.data_ptr(), out.data_ptr(), d, K, m, n1,
        kernels.stream()), "spiral_firstdim")
    kernels.LAUNCHES["firstdim"] += 1
    return out


def finish_output(res: torch.Tensor, num_per: int, n2: int) -> torch.Tensor:
    """(2, d, n1, num_per*n2) -> (num_per, n1, n2, 2, d)."""
    crt, d, n1, _ = res.shape
    return res.reshape(crt, d, n1, num_per, n2).permute(3, 2, 4, 0, 1)
