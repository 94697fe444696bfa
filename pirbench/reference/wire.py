"""The wire formats as the plain client writes and reads them: SPQ2
queries, SPP1 public parameters and bit-packed responses.

Frozen copy, at commit 1095982, of spiral_tpu_torch/native.py (bit_pack,
bit_unpack, crt_lift_u64) and spiral_tpu_torch/serialize.py
(query_to_bytes, public_params_to_bytes, response_from_bytes).
"""
from __future__ import annotations

import io

import numpy as np
import torch

from .scheme import B_I, P_I, P_INV_MOD_B, SchemeParams

ENGINE_TAG = b"mxu".ljust(8)
QUERY_MAGIC = b"SPQ2"
PUB_MAGIC = b"SPP1"
QUERY_WORD_BITS = 56


def bit_pack(vals: np.ndarray, width: int) -> bytes:
    """Values at `width` bits each, least significant bit first."""
    v = np.ascontiguousarray(vals, dtype=np.uint64).ravel()
    bits = np.unpackbits(v.astype("<u8").view(np.uint8).reshape(-1, 8),
                         axis=1, bitorder="little")[:, :width]
    return np.packbits(bits.ravel(), bitorder="little").tobytes()


def bit_unpack(data: bytes, width: int, count: int) -> np.ndarray:
    need = count * width
    bits = np.zeros(need, dtype=np.uint8)
    got = np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                        bitorder="little")[:need]
    bits[:got.size] = got
    words = np.zeros((count, 64), dtype=np.uint8)
    words[:, :width] = bits.reshape(count, width)
    return np.packbits(words, axis=1, bitorder="little").view("<u8") \
        .astype(np.uint64).ravel()


def crt_lift(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Residue pairs (x mod P_I, y mod B_I) -> the value mod Q, uint64."""
    x = np.asarray(xs, dtype=np.uint64)
    y = np.asarray(ys, dtype=np.uint64)
    p, b = np.uint64(P_I), np.uint64(B_I)
    diff = (y + b - x % b) % b
    return x + p * (diff * np.uint64(P_INV_MOD_B) % b)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def query_to_bytes(q) -> bytes:
    """SPQ2: magic, engine tag, the 4-byte seed, then packed_b, first_b and
    gsw_b, each a 4-byte length (0 where absent: a packed query has no
    first_b or gsw_b), a 4-byte poly count and 56-bit Garner-lifted
    words."""
    h = _u32(q.packed_b)                                  # (n, 1, 1, 2, d)
    v = crt_lift(h[..., 0, :], h[..., 1, :])
    packed = bit_pack(v, QUERY_WORD_BITS)
    absent = (0).to_bytes(4, "little")
    return b"".join([QUERY_MAGIC, ENGINE_TAG,
                     int(q.seed).to_bytes(4, "little"),
                     len(packed).to_bytes(4, "little"),
                     int(np.prod(v.shape[:-1])).to_bytes(4, "little"),
                     packed, absent, absent])


def public_params_to_bytes(pub: dict) -> bytes:
    """SPP1: magic, engine tag, an 8-byte length and an npz of the fields
    (the W_exp_* lists stacked)."""
    fields = {name: np.stack([_u32(w) for w in v]) if isinstance(v, list)
              else _u32(v) for name, v in pub.items()}
    buf = io.BytesIO()
    np.savez(buf, **fields)
    payload = buf.getvalue()
    return PUB_MAGIC + ENGINE_TAG + len(payload).to_bytes(8, "little") + \
        payload


def response_from_bytes(data: bytes, params: SchemeParams
                        ) -> tuple[np.ndarray, np.ndarray]:
    """A Spiral response's bytes -> its rows (1, n2, d) mod q' and (n0, n2,
    d) mod 4p, uint64."""
    qp_bits, q1_bits = params.response_widths
    d, rows, cols = params.poly_len, params.n1, params.n2
    b1_len = int.from_bytes(data[:4], "little")
    first = bit_unpack(data[4:4 + b1_len], qp_bits, cols * d)
    rest = bit_unpack(data[4 + b1_len:], q1_bits, (rows - 1) * cols * d)
    return first.reshape(1, cols, d), rest.reshape(rows - 1, cols, d)
