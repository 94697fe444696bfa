"""State exchange with the JAX package, through numpy arrays.

Both packages keep residues below 2^28 in the same (..., 2, d) layout and
the same NTT slot order, so keys, public params and queries convert by a
dtype change; only the encoded databases change layout (server/db.py,
pack.py).  Callers turn JAX arrays into numpy with np.asarray.  Every
converter puts its tensors on `device`, the card unless the caller names
another.
"""
from __future__ import annotations

import numpy as np
import torch

from .params import Params
from .crypto.keys import SecretKeys
from .crypto.publicparams import PublicParams
from .crypto.query import Query
from .pack import PackPublicParams
from .server.db import EncodedDb


def to_torch(a, device="cuda") -> torch.Tensor:
    """uint32 residues (numpy) -> int32 tensor."""
    a = np.asarray(a)
    assert a.size == 0 or int(a.max()) < (1 << 31)
    return torch.from_numpy(a.astype(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 residues -> uint32 numpy, as the JAX package holds them."""
    return t.cpu().numpy().astype(np.uint32)


def secret_keys(Sp, sr, Sp_centered, sr_centered, device="cuda"
                ) -> SecretKeys:
    """From spiral_tpu SecretKeys fields (either client's): Sp.data, sr.data
    (uint32) and the centered int64 arrays."""
    return SecretKeys(Sp=to_torch(Sp, device), sr=to_torch(sr, device),
                      Sp_centered=np.asarray(Sp_centered, dtype=np.int64),
                      sr_centered=np.asarray(sr_centered, dtype=np.int64))


def _keys(ws, device):
    """A list of W_exp_*[r].data, or None where the JAX params hold None."""
    return None if ws is None else [to_torch(w, device) for w in ws]


def _keys_to_numpy(ws):
    return None if ws is None else [to_numpy(w) for w in ws]


def public_params(W_exp_left, W_exp_right, W_conv, V,
                  device="cuda") -> PublicParams:
    """From spiral_tpu PublicParams: the lists of W_exp_*[r].data (None
    where they are None: a direct upload) and W_conv.data, V.data."""
    return PublicParams(
        W_exp_left=_keys(W_exp_left, device),
        W_exp_right=_keys(W_exp_right, device),
        W_conv=to_torch(W_conv, device), V=to_torch(V, device))


def public_params_to_numpy(pub: PublicParams) -> dict:
    """The fields of a spiral_tpu PublicParams as uint32 arrays
    (W_exp_left/right as lists, or None)."""
    return {"W_exp_left": _keys_to_numpy(pub.W_exp_left),
            "W_exp_right": _keys_to_numpy(pub.W_exp_right),
            "W_conv": to_numpy(pub.W_conv), "V": to_numpy(pub.V)}


def pack_public_params(v_W, W_exp_left, W_exp_right, V,
                       device="cuda") -> PackPublicParams:
    """From spiral_tpu.pack PackPublicParams: v_W, the lists of
    W_exp_*[r].data and V.data, each None where the JAX field is (a
    direct upload)."""
    return PackPublicParams(
        v_W=to_torch(v_W, device),
        W_exp_left=_keys(W_exp_left, device),
        W_exp_right=_keys(W_exp_right, device),
        V=None if V is None else to_torch(V, device))


def pack_public_params_to_numpy(pub: PackPublicParams) -> dict:
    """The fields of a spiral_tpu.pack PackPublicParams as uint32 arrays
    (W_exp_left/right as lists), None where the port's are None."""
    return {"v_W": to_numpy(pub.v_W),
            "W_exp_left": _keys_to_numpy(pub.W_exp_left),
            "W_exp_right": _keys_to_numpy(pub.W_exp_right),
            "V": None if pub.V is None else to_numpy(pub.V)}


def encoded_db(data, params: Params, device="cuda") -> EncodedDb:
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


def pack_encoded_db(data, params: Params, device="cuda") -> EncodedDb:
    """spiral_tpu.pack encode_pack_db data (T, num_per, 1, dim0, 2, d) ->
    the port's (2, d, dim0, T*num_per) layout."""
    t = to_torch(data, device)[:, :, 0]
    T, num_per, dim0, _, d = t.shape
    return EncodedDb(t.permute(3, 4, 2, 0, 1).reshape(2, d, dim0,
                                                      T * num_per)
                     .contiguous(), params)


def pack_encoded_db_to_jax_layout(db: EncodedDb) -> np.ndarray:
    """The port's pack database -> spiral_tpu.pack's layout (uint32)."""
    p = db.params
    _, d, dim0, _ = db.data.shape
    t = db.data.reshape(2, d, dim0, p.out_n ** 2, p.num_per)
    return to_numpy(t.permute(3, 4, 2, 0, 1)[:, :, None])


def query(seed: int, packed_b=None, device="cuda", *, first_b=None,
          gsw_b=None) -> Query:
    """From a spiral_tpu Query, either client's: its packed_b, or its
    first_b and gsw_b (the direct form)."""
    q = Query(seed=int(seed))
    for name, b in (("packed_b", packed_b), ("first_b", first_b),
                    ("gsw_b", gsw_b)):
        if b is not None:
            setattr(q, name, to_torch(b, device))
            q.size_bytes += b.shape[0] * b.shape[-1] * 7   # 56-bit words
    return q


def query_to_numpy(q: Query) -> dict:
    """The fields of a spiral_tpu Query: seed, and packed_b, first_b and
    gsw_b as uint32 arrays or None."""
    return {"seed": q.seed, **{
        name: None if getattr(q, name) is None else to_numpy(getattr(q, name))
        for name in ("packed_b", "first_b", "gsw_b")}}


def response_rows(resp) -> tuple[np.ndarray, np.ndarray]:
    """A Response (either package) -> its (first_row, rest_rows) as int64."""
    return (np.asarray(resp.first_row, dtype=np.int64),
            np.asarray(resp.rest_rows, dtype=np.int64))
