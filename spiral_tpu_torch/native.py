"""Host helpers of the wire formats, in numpy (the port's own copy of what
serialize.py needs from spiral_tpu/native.py and its C++ runtime
native/spiral_native.cpp): bit packing at an arbitrary width and the
Garner lift of CRT residue pairs.  Both are exact in uint64 numpy, so
there is nothing to build.
"""
from __future__ import annotations

import math

import numpy as np


def _grouping(width: int) -> tuple[int, int, int]:
    """(g, nbytes, nwords): g = 8 / gcd(width, 8) values of `width` bits
    fill exactly nbytes = g * width / 8 bytes, held in nwords uint64
    words (10 bits: 4 values in 5 bytes; 22: 4 in 11; 56: 1 in 7)."""
    if not 0 < width <= 64:
        raise ValueError(f"bit width {width} outside 1-64")
    g = 8 // math.gcd(width, 8)
    nbytes = g * width // 8
    return g, nbytes, -(-nbytes // 8)


def _places(width: int, g: int):
    """For value k of a group: the word its bits start in, their shift
    there, and whether they run on into the next word."""
    for k in range(g):
        word, shift = divmod(k * width, 64)
        yield k, word, shift, shift + width > 64


def bit_pack(vals: np.ndarray, width: int) -> bytes:
    """Values at `width` bits each, least significant bit first: bit i of
    value k is global bit k*width + i.  Each value is masked to its width
    (as the C++ bit_pack does).  ceil(n*width/8) bytes.  Any integer
    dtype.  Each group of g values is shifted and ORed into little-endian
    uint64 words whose first nbytes bytes are the group's bytes."""
    g, nbytes, nwords = _grouping(width)
    v = np.asarray(vals, dtype=np.uint64).reshape(-1)
    n = v.size
    if n % g:
        v = np.concatenate([v, np.zeros(g - n % g, np.uint64)])
    cols = v.reshape(-1, g).T.copy()            # value k of every group
    if width < 64:
        cols &= np.uint64((1 << width) - 1)
    acc = [np.uint64(0)] * nwords
    for k, word, shift, spills in _places(width, g):
        acc[word] = acc[word] | (cols[k] << np.uint64(shift))
        if spills:
            acc[word + 1] = acc[word + 1] | (cols[k] >> np.uint64(64 - shift))
    words = np.empty((cols.shape[1], nwords), dtype="<u8")
    for a, col in enumerate(acc):
        words[:, a] = col
    # a contiguous copy first: tobytes() of the strided view is slow
    out = np.ascontiguousarray(words.view(np.uint8)[:, :nbytes])
    return out.reshape(-1)[:(n * width + 7) // 8].tobytes()


def bit_unpack(data: bytes, width: int, count: int) -> np.ndarray:
    """`count` values of `width` bits from bit_pack's layout, as uint64;
    bits past the end of `data` read as 0."""
    g, nbytes, nwords = _grouping(width)
    groups = -(-count // g)
    raw = np.frombuffer(data, dtype=np.uint8)[:groups * nbytes]
    if raw.size < groups * nbytes:
        raw = np.concatenate([raw, np.zeros(groups * nbytes - raw.size,
                                            np.uint8)])
    buf = np.zeros((groups, nwords * 8), dtype=np.uint8)
    buf[:, :nbytes] = raw.reshape(groups, nbytes)
    words = buf.view("<u8")
    out = np.empty((groups, g), dtype=np.uint64)
    for k, word, shift, spills in _places(width, g):
        x = words[:, word] >> np.uint64(shift)
        if spills:
            x |= words[:, word + 1] << np.uint64(64 - shift)
        out[:, k] = x
    if width < 64:
        out &= np.uint64((1 << width) - 1)
    return out.reshape(-1)[:count]


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
