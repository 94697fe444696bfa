"""State exchange with the JAX package, through numpy arrays.

Both packages keep residues below 2^28 in the same (..., 2, d) layout and
the same NTT slot order, so keys, public params and queries convert by a
dtype change; only the encoded database changes layout (server/db.py).
Callers turn JAX arrays into numpy with np.asarray.
"""
from __future__ import annotations

import numpy as np
import torch

from spiral_tpu.params import Params
from .crypto.keys import SecretKeys
from .crypto.publicparams import PublicParams
from .crypto.query import Query
from .server.db import EncodedDb


def to_torch(a, device="cpu") -> torch.Tensor:
    """uint32 residues (numpy) -> int32 tensor."""
    a = np.asarray(a)
    assert a.size == 0 or int(a.max()) < (1 << 31)
    return torch.from_numpy(a.astype(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 residues -> uint32 numpy, as the JAX package holds them."""
    return t.cpu().numpy().astype(np.uint32)


def secret_keys(Sp, sr, Sp_centered, sr_centered, device="cpu") -> SecretKeys:
    """From spiral_tpu SecretKeys fields: Sp.data, sr.data (uint32) and the
    centered int64 arrays."""
    return SecretKeys(Sp=to_torch(Sp, device), sr=to_torch(sr, device),
                      Sp_centered=np.asarray(Sp_centered, dtype=np.int64),
                      sr_centered=np.asarray(sr_centered, dtype=np.int64))


def public_params(W_exp_left, W_exp_right, W_conv, V,
                  device="cpu") -> PublicParams:
    """From spiral_tpu PublicParams: the lists of W_exp_*[r].data and
    W_conv.data, V.data."""
    return PublicParams(
        W_exp_left=[to_torch(w, device) for w in W_exp_left],
        W_exp_right=[to_torch(w, device) for w in W_exp_right],
        W_conv=to_torch(W_conv, device), V=to_torch(V, device))


def encoded_db(data, params: Params, device="cpu") -> EncodedDb:
    """spiral_tpu EncodedDb.data (num_per, n2, K, 2, d) -> the port's
    (2, d, K, num_per*n2) layout."""
    t = to_torch(data, device)
    num_per, n2, K, _, d = t.shape
    return EncodedDb(t.permute(3, 4, 2, 0, 1).reshape(2, d, K, num_per * n2)
                     .contiguous(), params)


def encoded_db_to_jax_layout(db: EncodedDb) -> np.ndarray:
    """The port's database -> spiral_tpu EncodedDb.data layout (uint32)."""
    p = db.params
    _, d, K, _ = db.data.shape
    t = db.data.reshape(2, d, K, p.num_per, p.n2).permute(3, 4, 2, 0, 1)
    return to_numpy(t)


def query(seed: int, packed_b, device="cpu") -> Query:
    """From a spiral_tpu Query (seed, packed_b)."""
    b = to_torch(packed_b, device)
    return Query(seed=int(seed), packed_b=b, size_bytes=b.shape[-1] * 7)


def query_to_numpy(q: Query) -> tuple[int, np.ndarray]:
    """(seed, packed_b as uint32), the fields of a spiral_tpu Query."""
    return q.seed, to_numpy(q.packed_b)


def response_rows(resp) -> tuple[np.ndarray, np.ndarray]:
    """A Response (either package) -> its (first_row, rest_rows) as int64."""
    return (np.asarray(resp.first_row, dtype=np.int64),
            np.asarray(resp.rest_rows, dtype=np.int64))
