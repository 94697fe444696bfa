"""End to end: the port's server answers JAX SpiralClient queries with the
JAX server's exact response rows, and the port's own client and server
decode correctly."""
from collections import defaultdict

import numpy as np
import jax.numpy as jnp
import pytest

from spiral_tpu import pir as jpir
from spiral_tpu.crypto import query as j_query
from spiral_tpu.crypto.query import reconstruct_cts as j_reconstruct_cts
from spiral_tpu.params import Params, preset
from spiral_tpu_torch import params as tparams
from spiral_tpu.server.db import encode_db as j_encode_db
from spiral_tpu.server.db import random_db as j_random_db
from spiral_tpu_torch import interop
from spiral_tpu_torch.crypto import query as t_query
from spiral_tpu_torch.crypto.decode import decode_response
from spiral_tpu_torch.crypto.query import reconstruct_cts
from spiral_tpu_torch.pir import SpiralClient, SpiralServer, run_pir
from spiral_tpu_torch.server import db as torch_db
from spiral_tpu_torch.server import fold
from spiral_tpu_torch.server.db import encode_db, random_db

# stopround > 0 (5 of g = 6), t_gsw = 9 (7-bit signed digits), m_exp_right
# = 56 (one-bit digits), on a small ring
STOP_CFG = dict(nu_1=5, nu_2=2, p_db=256, q_prime_bits=20, t_gsw=9,
                t_conv=4, t_exp=8, t_exp_right=56, poly_len=128)


# the fold's engine per round: the default rule (K3 in every round at
# these small configurations), K3 forced, and K8b (the JAX SPIRAL_FOLD=mxu
# path) in every round
FOLD_RULES = {"default": fold.MXU_MIN_COLS, "k3": {},
              "k8b": defaultdict(int)}


@pytest.fixture(scope="module")
def jax_run():
    """cfg -> (JAX params, port params, client, pub, pts, jdb, query, the
    JAX server's response), each made once for the module."""
    runs = {}

    def get(cfg):
        if cfg not in runs:
            p = preset("tiny") if cfg == "tiny" else Params(**STOP_CFG)
            tp = tparams.preset("tiny") if cfg == "tiny" else \
                tparams.Params(**STOP_CFG)
            assert (p.stopround > 0) == (cfg == "stopround")
            client = jpir.SpiralClient(p, seed=7)
            pub = client.setup()
            pts = j_random_db(p, np.random.default_rng(2))
            jdb = j_encode_db(pts, p)
            q = client.query(p.total_n - 1)
            want, _ = jpir.SpiralServer(p, jdb, pub).process_query(q)
            runs[cfg] = (p, tp, client, pub, pts, jdb, q, want)
        return runs[cfg]

    return get


@pytest.mark.parametrize("cfg, engines", [
    ("tiny", "default"), ("stopround", "default"),
    ("tiny", "k3"), ("stopround", "k3"),
    ("tiny", "k8b"), ("stopround", "k8b")],
    ids=["tiny", "stopround", "tiny-k3", "stopround-k3", "tiny-k8b",
         "stopround-k8b"])
def test_torch_server_answers_jax_client(jax_run, monkeypatch, cfg,
                                         engines):
    p, tp, client, pub, pts, jdb, q, want = jax_run(cfg)
    monkeypatch.setattr(fold, "MXU_MIN_COLS", FOLD_RULES[engines])
    tserver = SpiralServer(
        tp, interop.encoded_db(np.asarray(jdb.data), tp, "cpu"),
        interop.public_params([np.asarray(w.data) for w in pub.W_exp_left],
                              [np.asarray(w.data) for w in pub.W_exp_right],
                              np.asarray(pub.W_conv.data),
                              np.asarray(pub.V.data), "cpu"))
    idx = p.total_n - 1
    got, _ = tserver.process_query(interop.query(
        q.seed, np.asarray(q.packed_b), "cpu"))
    for a, b in zip(interop.response_rows(got), interop.response_rows(want)):
        np.testing.assert_array_equal(a, b)
    # process_query ran the stage chain
    assert list(tserver.graphs.programs) == [("stages", False, 1)]
    keys = interop.secret_keys(np.asarray(client.keys.Sp.data),
                               np.asarray(client.keys.sr.data),
                               client.keys.Sp_centered,
                               client.keys.sr_centered, "cpu")
    assert np.array_equal(decode_response(got, keys.Sp_centered, tp),
                          pts[idx].astype(object))


def test_jax_rebuilds_torch_client_query():
    """The JAX server's reconstruct_cts turns a torch-client query into the
    same ciphertext as the port's: the a halves come from one stream."""
    q = SpiralClient(tparams.preset("tiny"), seed=5, device="cpu").query(3)
    fields = interop.query_to_numpy(q)
    want = j_reconstruct_cts(jnp.int32(fields["seed"]),
                             jnp.asarray(fields["packed_b"]))
    np.testing.assert_array_equal(
        interop.to_numpy(reconstruct_cts(q.seed, q.packed_b)),
        np.asarray(want))


@pytest.mark.parametrize("cfg", ["tiny", "stopround"])
def test_packed_sigma_matches_jax(cfg):
    """The packed query's plaintext equals JAX _sigma_poly's as exact
    integers, without and with the stopround interleave."""
    p = preset("tiny") if cfg == "tiny" else Params(**STOP_CFG)
    tp = tparams.preset("tiny") if cfg == "tiny" else \
        tparams.Params(**STOP_CFG)
    for idx in (0, p.total_n - 1, p.num_per + 1):
        want = j_query._sigma_poly(p, idx)
        got = t_query.sigma_poly(tp, idx, tp.g, tp.stopround)
        assert (got == want).all()


def test_torch_db_encoding_matches_jax(monkeypatch):
    p, tp = preset("tiny"), tparams.preset("tiny")
    pts = random_db(tp, np.random.default_rng(3))
    np.testing.assert_array_equal(pts, j_random_db(p, np.random.default_rng(3)))
    monkeypatch.setattr(torch_db, "BLOCK_POLYS", 32)    # several blocks
    got = interop.encoded_db_to_jax_layout(encode_db(pts, tp, "cpu"))
    np.testing.assert_array_equal(got, np.asarray(j_encode_db(pts, p).data))


@pytest.mark.parametrize("nonoise", [True, False])
def test_torch_client_and_server_decode(nonoise):
    for idx in (0, 15):
        correct, timings, _, _ = run_pir(tparams.preset("tiny"), idx=idx,
                                         seed=4, nonoise=nonoise,
                                         device="cpu")
        assert correct and timings.total_us > 0
