"""Wire formats (counterpart of spiral_tpu/serialize.py), byte for byte
with the JAX package: what one package writes, the other reads.

- Responses: row 0 bit-packed at q'-width bits a coefficient, the other
  rows at log2(4 p) bits, after the 4-byte length of the first block
  (ref: src/spiral.cpp:40-78, src/client.cpp:90-112).
- Queries, SPQ2: magic, an 8-byte NTT-engine tag, the 4-byte seed, then
  packed_b, first_b and gsw_b, each a 4-byte length (0 where absent), a
  4-byte poly count and 56-bit Garner-lifted words.
- Public parameters, SPP1: magic, the engine tag, an 8-byte length and an
  npz of the fields present (W_exp_left, W_exp_right, W_conv, V, v_W); a
  v_W field makes them a PackPublicParams.
- Database checkpoints: a .npy in the JAX EncodedDb.data layout and a
  .json of the Params fields with the engine and row-layout tags.

All NTT-domain data is tagged with the engine whose slot order it uses.
The port's is the JAX ``mxu`` engine's (the JAX default on the CPU); it
writes that tag and, as the JAX package does, refuses any other: slot
orders are not converted.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
import pathlib

import numpy as np

from . import interop, native, tracing
from .params import B_I, P_I, Params
from .arith.crt import P_INV_MOD_B
from .crypto.decode import Response
from .crypto.publicparams import PublicParams
from .crypto.query import Query
from .pack import PackPublicParams
from .server.db import EncodedDb

NTT_ENGINE = "mxu"
QUERY_MAGIC = b"SPQ2"
PUB_MAGIC = b"SPP1"
DB_LAYOUT = "bitrev-v1"
QUERY_WORD_BITS = 56


def _engine_tag() -> bytes:
    return NTT_ENGINE.encode().ljust(8)


def _response_widths(params: Params) -> tuple[int, int]:
    return params.bits_to_hold_arb_qprime, int(math.log2(4 * params.p_db))


def response_to_bytes(resp: Response, params: Params) -> bytes:
    with tracing.span("pack"):
        qp_bits, q1_bits = _response_widths(params)
        b1 = native.bit_pack(resp.first_row, qp_bits)
        b2 = native.bit_pack(resp.rest_rows, q1_bits)
        return len(b1).to_bytes(4, "little") + b1 + b2


def response_from_bytes(data: bytes, params: Params, rows: int,
                        cols: int) -> Response:
    """rows x cols polys (n1 x n2 for Spiral, out_n + 1 x out_n for the
    pack variant) -> a Response of uint64 arrays, as the JAX reader
    gives."""
    qp_bits, q1_bits = _response_widths(params)
    d = params.poly_len
    b1_len = int.from_bytes(data[:4], "little")
    first = native.bit_unpack(data[4:4 + b1_len], qp_bits, cols * d)
    rest = native.bit_unpack(data[4 + b1_len:], q1_bits,
                             (rows - 1) * cols * d)
    return Response(first_row=first.reshape(1, cols, d),
                    rest_rows=rest.reshape(rows - 1, cols, d))


def query_to_bytes(query: Query, params: Params) -> bytes:
    """The seed and the b rows, each coefficient's residue pair
    Garner-lifted to one 56-bit word (logQ bits a coefficient, the
    reference's query accounting)."""
    parts = [QUERY_MAGIC, _engine_tag(),
             int(query.seed).to_bytes(4, "little")]
    for field in (query.packed_b, query.first_b, query.gsw_b):
        if field is None:
            parts.append((0).to_bytes(4, "little"))
            continue
        h = interop.to_numpy(field)                      # (n, 1, 1, 2, d)
        v = native.crt_lift_u64(h[..., 0, :], h[..., 1, :], P_I, B_I,
                                P_INV_MOD_B)
        packed = native.bit_pack(v, QUERY_WORD_BITS)
        parts += [len(packed).to_bytes(4, "little"),
                  int(np.prod(v.shape[:-1])).to_bytes(4, "little"), packed]
    return b"".join(parts)


def _check_engine(eng: str, what: str, hint: str) -> None:
    if eng != NTT_ENGINE:
        raise ValueError(
            f"{what} under NTT engine {eng!r}; active engine "
            f"is {NTT_ENGINE!r} (slot orders differ){hint}")


def query_from_bytes(data: bytes, params: Params, device="cuda") -> Query:
    """SPQ2 bytes -> a Query with its b rows (n, 1, 1, 2, d) on `device`
    and size_bytes = len(data)."""
    with tracing.span("parse"):
        if data[:4] == b"SPQ1":
            raise ValueError(
                "query uses the retired SPQ1 wire format (no NTT-engine "
                "tag); re-serialize it with this library version")
        if data[:4] != QUERY_MAGIC:
            raise ValueError(f"bad query magic {data[:4]!r}")
        _check_engine(data[4:12].decode().strip(), "query was serialized",
                      " — pin both sides with "
                      "spiral_tpu.arith.ntt.set_engine or SPIRAL_NTT")
        seed = int.from_bytes(data[12:16], "little")
        off, d = 16, params.poly_len
        fields = []
        for _ in range(3):
            blen = int.from_bytes(data[off:off + 4], "little")
            off += 4
            if blen == 0:
                fields.append(None)
                continue
            npolys = int.from_bytes(data[off:off + 4], "little")
            v = native.bit_unpack(data[off + 4:off + 4 + blen],
                                  QUERY_WORD_BITS,
                                  npolys * d).reshape(npolys, 1, 1, d)
            off += 4 + blen
            fields.append(interop.to_torch(
                np.stack([v % np.uint64(P_I), v % np.uint64(B_I)], axis=-2),
                device))
        return Query(seed=seed, packed_b=fields[0], first_b=fields[1],
                     gsw_b=fields[2], size_bytes=len(data))


def _layout(db: EncodedDb) -> str:
    """'spiral' (K = dim0*n0 rows) or 'pack' (K = dim0) from the encoded
    database's shape."""
    p, K = db.params, db.data.shape[2]
    if p.n0 == 1 or K not in (p.dim0, p.dim0 * p.n0):
        raise ValueError(f"cannot tell the layout of a database of shape "
                         f"{tuple(db.data.shape)} at n0 {p.n0}, dim0 "
                         f"{p.dim0}")
    return "pack" if K == p.dim0 else "spiral"


def save_db(db: EncodedDb, path: str) -> None:
    """Write the encoded database as the JAX package does: path.npy in the
    JAX layout ((num_per, n2, K, 2, d) for Spiral, (T, num_per, 1, dim0, 2,
    d) for the pack variant) and path.json with the Params fields and the
    engine and row-layout tags."""
    p = pathlib.Path(path)
    to_jax = interop.encoded_db_to_jax_layout if _layout(db) == "spiral" \
        else interop.pack_encoded_db_to_jax_layout
    np.save(str(p.with_suffix(".npy")), to_jax(db))
    meta = dataclasses.asdict(db.params)
    meta["__ntt_engine__"] = NTT_ENGINE
    # fold rounds pair adjacent rows, which needs encode_db's bit-reversed
    # row order; load_db refuses a checkpoint without this tag
    meta["__layout__"] = DB_LAYOUT
    p.with_suffix(".json").write_text(json.dumps(meta))


def load_db(path: str, device="cuda") -> EncodedDb:
    """A checkpoint of either package -> the port's EncodedDb on
    `device`."""
    p = pathlib.Path(path)
    data = np.load(str(p.with_suffix(".npy")))
    meta = json.loads(p.with_suffix(".json").read_text())
    eng = meta.pop("__ntt_engine__", "mxu")
    layout = meta.pop("__layout__", None)
    if layout != DB_LAYOUT:
        raise ValueError(
            f"DB checkpoint has row layout {layout!r}; this build folds "
            "adjacent bit-reversed rows ('bitrev-v1') and an untagged "
            "(pre-layout-tag) checkpoint would decode the wrong record — "
            "re-encode the database with encode_db + save_db")
    params = Params(**meta)
    _check_engine(eng, "DB was encoded", " — re-encode the DB or pin the "
                  "engine with spiral_tpu.arith.ntt.set_engine")
    from_jax = interop.encoded_db if data.ndim == 5 else \
        interop.pack_encoded_db
    return from_jax(data, params, device)


def public_params_to_bytes(pub: PublicParams | PackPublicParams) -> bytes:
    """Either variant's public parameters -> SPP1 bytes."""
    fields = {}
    for name in ("W_exp_left", "W_exp_right", "W_conv", "V", "v_W"):
        v = getattr(pub, name, None)
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            fields[name] = np.stack([interop.to_numpy(w) for w in v]) \
                if v else np.zeros((0,), dtype=np.uint32)
        else:
            fields[name] = interop.to_numpy(v)
    buf = io.BytesIO()
    np.savez(buf, **fields)
    payload = buf.getvalue()
    return PUB_MAGIC + _engine_tag() + len(payload).to_bytes(8, "little") + \
        payload


def public_params_from_bytes(data: bytes, params: Params, device="cuda"
                             ) -> PublicParams | PackPublicParams:
    """SPP1 bytes -> PublicParams, or PackPublicParams where v_W is
    present, on `device`, size_bytes = len(data)."""
    if data[:4] != PUB_MAGIC:
        raise ValueError(f"bad public-params magic {data[:4]!r}")
    _check_engine(data[4:12].decode().strip(),
                  "public params were serialized", "")
    plen = int.from_bytes(data[12:20], "little")
    z = np.load(io.BytesIO(data[20:20 + plen]))

    def mats(name):
        if name not in z:
            return None
        return [interop.to_torch(a, device) for a in z[name]] or None

    def mat(name):
        return interop.to_torch(z[name], device) if name in z else None

    if "v_W" in z:
        return PackPublicParams(
            v_W=mat("v_W"), W_exp_left=mats("W_exp_left"),
            W_exp_right=mats("W_exp_right"), V=mat("V"),
            size_bytes=len(data))
    return PublicParams(W_exp_left=mats("W_exp_left"),
                        W_exp_right=mats("W_exp_right"), W_conv=mat("W_conv"),
                        V=mat("V"), size_bytes=len(data))
