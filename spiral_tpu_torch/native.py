"""Host helpers of the wire formats, in numpy (the port's own copy of what
serialize.py needs from spiral_tpu/native.py and its C++ runtime
native/spiral_native.cpp): bit packing at an arbitrary width and the
Garner lift of CRT residue pairs.  Both are exact in uint64 numpy, so
there is nothing to build.
"""
from __future__ import annotations

import numpy as np


def bit_pack(vals: np.ndarray, width: int) -> bytes:
    """Values at `width` bits each, least significant bit first: bit i of
    value k is global bit k*width + i.  Each value is masked to its width
    (as the C++ bit_pack does).  ceil(n*width/8) bytes."""
    if not 0 < width <= 64:
        raise ValueError(f"bit width {width} outside 1-64")
    v = np.ascontiguousarray(vals, dtype=np.uint64).ravel()
    bits = np.unpackbits(v.astype("<u8").view(np.uint8).reshape(-1, 8),
                         axis=1, bitorder="little")[:, :width]
    return np.packbits(bits.ravel(), bitorder="little").tobytes()


def bit_unpack(data: bytes, width: int, count: int) -> np.ndarray:
    """`count` values of `width` bits from bit_pack's layout, as uint64;
    bits past the end of `data` read as 0."""
    if not 0 < width <= 64:
        raise ValueError(f"bit width {width} outside 1-64")
    need = count * width
    bits = np.zeros(need, dtype=np.uint8)
    got = np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                        bitorder="little")[:need]
    bits[:got.size] = got
    words = np.zeros((count, 64), dtype=np.uint8)
    words[:, :width] = bits.reshape(count, width)
    return np.packbits(words, axis=1, bitorder="little").view("<u8") \
        .astype(np.uint64).ravel()


def crt_lift_u64(xs: np.ndarray, ys: np.ndarray, mod_p: int, mod_b: int,
                 p_inv_mod_b: int) -> np.ndarray:
    """Residue pairs (x mod P, y mod B) -> the value mod P*B as uint64:
    x + P*(((y - x) mod B)*p_inv mod B).  With P, B < 2^28 every product
    stays below 2^56."""
    x = np.asarray(xs, dtype=np.uint64)
    y = np.asarray(ys, dtype=np.uint64)
    p, b = np.uint64(mod_p), np.uint64(mod_b)
    diff = (y + b - x % b) % b
    return x + p * (diff * np.uint64(p_inv_mod_b) % b)
