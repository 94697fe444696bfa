"""The implicit huge-database mode: the port's random slabs, chunked
first-dim multiply and servers against the JAX package's on the same
numpy generator.  The answers of this mode do not decode (the slab is
random), so the check is the response rows, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest

from spiral_tpu import pack as jpack
from spiral_tpu import pir as jpir
from spiral_tpu.params import B_I, P_I, preset
from spiral_tpu.server import db as jdb
from spiral_tpu.server.firstdim import (N_LIMBS, finish_mxu_output,
                                        multiply_query_by_db_implicit,
                                        multiply_query_by_db_implicit_batch)
from spiral_tpu_torch import interop, pack, pir
from spiral_tpu_torch import params as tparams
from spiral_tpu_torch.server import db as torch_db
from spiral_tpu_torch.server import firstdim

# tiny: a first-dimension row of Spiral's slab is n2*K*2*d*4 = 32 KiB, so
# 64 KiB gives 2 rows per slab and 2 chunks; the pack's is 16 KiB (K = 4)
# over 16 rows, so 64 KiB gives 4 rows and 4 chunks
SLAB_BYTES = 64 << 10


def _residues_of_limbs(limbs) -> np.ndarray:
    """A JAX slab's int8 7-bit limbs (2, d, K, 4*m), limb-major columns ->
    the residues (2, d, K, m)."""
    v = np.asarray(limbs).astype(np.int64)
    v = v.reshape(v.shape[:3] + (N_LIMBS, -1))
    return sum(v[:, :, :, j] << (7 * j) for j in range(N_LIMBS))


def _slabs(name, pack_db: bool, seed: int):
    p, tp = preset(name), tparams.preset(name)
    jmake = jdb.random_implicit_pack_db if pack_db else jdb.random_implicit_db
    tmake = (torch_db.random_implicit_pack_db if pack_db
             else torch_db.random_implicit_db)
    jslab = jmake(p, np.random.default_rng(seed), max_slab_bytes=SLAB_BYTES)
    tslab = tmake(tp, np.random.default_rng(seed),
                  max_slab_bytes=SLAB_BYTES, device="cpu")
    return p, tp, jslab, tslab


@pytest.mark.parametrize("name, pack_db", [("tiny", False),
                                           ("tiny_pack", True),
                                           ("tiny_pack4", True)])
def test_random_implicit_db_matches_jax(name, pack_db):
    _, _, jslab, tslab = _slabs(name, pack_db, 21)
    assert (tslab.slab_per, tslab.num_chunks) == (jslab.slab_per,
                                                  jslab.num_chunks)
    assert tslab.num_chunks > 1
    np.testing.assert_array_equal(tslab.slab.numpy(),
                                  _residues_of_limbs(jslab.slab_limbs))


@pytest.mark.parametrize("num_chunks", [1, 3])
@pytest.mark.parametrize("B", [1, 2])
def test_firstdim_implicit_matches_jax(num_chunks, B):
    p, tp, jslab, tslab = _slabs("tiny", False, 22)
    rng = np.random.default_rng(23 + B)
    K = p.dim0 * p.n0
    qk = np.stack([rng.integers(0, P_I, (B, K, p.n1, p.poly_len)),
                   rng.integers(0, B_I, (B, K, p.n1, p.poly_len))],
                  axis=-2).astype(np.uint32)
    if B == 1:
        want = multiply_query_by_db_implicit(jslab.slab_limbs,
                                             jnp.asarray(qk[0]), num_chunks)
        got = firstdim.multiply_query_by_db_implicit(
            tslab.slab, interop.to_torch(qk[0], "cpu"), num_chunks)
    else:
        want = multiply_query_by_db_implicit_batch(
            jslab.slab_limbs, jnp.asarray(qk), num_chunks)
        got = firstdim.multiply_query_by_db_implicit_batch(
            tslab.slab, interop.to_torch(qk, "cpu"), num_chunks)
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


def _same_rows(got, want):
    for a, b in zip(interop.response_rows(got), interop.response_rows(want)):
        np.testing.assert_array_equal(a, b)


def test_implicit_spiral_server_matches_jax():
    """The port's rows for a query over an implicit database are the JAX
    implicit server's; the port's batch over it (the chunked batched K2)
    gives each query its single run's rows."""
    p, tp, jslab, tslab = _slabs("tiny", False, 24)
    client = jpir.SpiralClient(p, seed=25)
    pub = client.setup()
    jserver = jpir.SpiralServer(p, jslab, pub)
    tserver = pir.SpiralServer(tp, tslab, interop.public_params(
        [np.asarray(w.data) for w in pub.W_exp_left],
        [np.asarray(w.data) for w in pub.W_exp_right],
        np.asarray(pub.W_conv.data), np.asarray(pub.V.data), "cpu"))
    qs = [client.query(i) for i in (5, p.total_n - 1)]
    tqs = [interop.query(q.seed, np.asarray(q.packed_b), "cpu") for q in qs]
    want, _ = jserver.process_query(qs[0])
    got = [tserver.process_query(q)[0] for q in tqs]
    _same_rows(got[0], want)
    got_b, _ = tserver.process_query_batch(tqs)
    for g, s in zip(got_b, got):
        _same_rows(g, s)


def test_implicit_pack_server_matches_jax():
    p, tp, jslab, tslab = _slabs("tiny_pack", True, 26)
    client = jpack.PackClient(p, seed=27)
    pub = client.setup()
    jserver = jpack.PackServer(p, jslab, pub)
    tserver = pack.PackServer(tp, tslab, interop.pack_public_params(
        np.asarray(pub.v_W), [np.asarray(w.data) for w in pub.W_exp_left],
        [np.asarray(w.data) for w in pub.W_exp_right],
        np.asarray(pub.V.data), "cpu"))
    q = client.query(p.total_n - 1)
    want, _ = jserver.process_query(q)
    got, _ = tserver.process_query(
        interop.query(q.seed, np.asarray(q.packed_b), "cpu"))
    _same_rows(got, want)


def test_finish_output_matches_jax():
    """The single-query output permutation the implicit server uses."""
    rng = np.random.default_rng(28)
    res = rng.integers(0, P_I, (2, 64, 3, 8)).astype(np.uint32)
    np.testing.assert_array_equal(
        interop.to_numpy(firstdim.finish_output(interop.to_torch(res, "cpu"),
                                                4, 2)),
        np.asarray(finish_mxu_output(jnp.asarray(res), 4, 2)))
