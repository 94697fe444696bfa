"""Response modulus switch on the server's device (counterpart of
spiral_tpu/crypto/decode.py modswitch_device), and the client's host-side
decode: the port's own copies of that module's ``Response``,
``negacyclic_conv_small`` and ``decode_response`` (exact integers, numpy)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..params import Params
from ..core.rescale import rescale_residues_device


@dataclasses.dataclass
class Response:
    """Two-modulus modswitched response (host uint64 arrays, the dtype
    serialize.response_from_bytes gives)."""

    first_row: np.ndarray   # (1, cols, d) values mod q'
    rest_rows: np.ndarray   # (rows-1, cols, d) values mod 4p


def modswitch_device(final: torch.Tensor, params: Params):
    """final (..., rows, cols, 2, d) residues -> (row 0 rescaled to q',
    rows 1.. rescaled to 4p) int32 tensors (..., 1, cols, d) and
    (..., rows-1, cols, d); a leading query axis as jax.vmap gives it."""
    first = rescale_residues_device(final[..., :1, :, 0, :],
                                    final[..., :1, :, 1, :],
                                    params.arb_qprime)
    rest = rescale_residues_device(final[..., 1:, :, 0, :],
                                   final[..., 1:, :, 1, :], 4 * params.p_db)
    return first, rest


def _response(first: torch.Tensor, rest: torch.Tensor) -> Response:
    """Host int32 rows -> a Response of uint64 arrays."""
    return Response(first_row=first.numpy().astype(np.uint64),
                    rest_rows=rest.numpy().astype(np.uint64))


def response_from_device_rows(first, rest) -> Response:
    """One query's rows: copied to the host (span "fetch"), then a
    Response (span "response" around both)."""
    with tracing.span("response"):
        with tracing.span("fetch"):
            first, rest = first.cpu(), rest.cpu()
        return _response(first, rest)


def responses_from_device_rows(first_b, rest_b) -> list[Response]:
    """A batch's rows (B, 1, cols, d) and (B, rows-1, cols, d): one copy to
    the host, then one Response per query (spans as
    response_from_device_rows)."""
    with tracing.span("response"):
        with tracing.span("fetch"):
            first_b, rest_b = first_b.cpu(), rest_b.cpu()
        return [_response(f, r) for f, r in zip(first_b, rest_b)]


def negacyclic_conv_small(a_small: np.ndarray, b: np.ndarray, q: int
                          ) -> np.ndarray:
    """a (int64 small, length d) (*) b (values < q, length d) mod q."""
    d = len(a_small)
    assert int(np.max(np.abs(a_small)) if d else 0) * d * q < 2 ** 62
    full = np.convolve(a_small.astype(np.int64), b.astype(np.int64))
    res = full[:d].copy()
    res[: d - 1] -= full[d:]
    return res % q


def decode_response(resp: Response, Sp_centered: np.ndarray, params: Params
                    ) -> np.ndarray:
    """Recombine to the plaintext matrix (ref: spiral.cpp:1452-1475).

    Sp_centered: (n, k, d) int64, n = n0 for Spiral and out_n for the pack
    client.  Returns (n, cols, d) ints mod p_db.
    """
    qp = params.arb_qprime
    q1 = 4 * params.p_db
    p = params.p_db
    n, k, d = Sp_centered.shape
    cols = resp.first_row.shape[1]
    assert resp.first_row.shape[0] == k == 1, "k_param == 1 supported"

    out = np.empty((n, cols, d), dtype=object)
    denom = qp * (q1 // p)
    for r in range(n):
        for c in range(cols):
            sp = negacyclic_conv_small(
                Sp_centered[r, 0], np.asarray(resp.first_row[0, c],
                                              dtype=np.int64), qp)
            val_first = np.where(sp >= qp // 2, sp - qp, sp).astype(np.int64)
            vr = np.asarray(resp.rest_rows[r, c], dtype=np.int64)
            val_rest = np.where(vr >= q1 // 2, vr - q1, vr)
            rr = val_first.astype(object) * q1 + val_rest.astype(object) * qp
            sign = np.where(rr >= 0, 1, -1)
            num = rr + sign * (denom // 2)
            res = num // denom + np.where((num % denom != 0) & (sign < 0), 1, 0)
            out[r, c] = res % p
    return out
