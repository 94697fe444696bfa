"""The port's scale-out (dist/shard.py, dist/multihost.py, SpiralServer /
PackServer(mesh=), the harness dist figure, graft_entry) over a world of
two gloo ranks on the CPU (tests/torch_dist_worker.py, jax blocked),
against the JAX package's mesh servers on two of its virtual devices.

The JAX side runs while the ranks do.  Its mesh servers take the stage
inputs of each query (composed first-dimension cts, converted GSW cts)
from the port's unsharded server, which tests/test_torch_e2e.py and
test_torch_batch.py already hold to JAX's, and run their own sharded
stage (first dim, local rounds, all-gather, tail) and modulus switch: the
response rows the JAX mesh server gives that query.  All arithmetic is
exact: the tolerance is 0."""
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__ as jentry
import torch_dist_worker as w
from spiral_tpu import pack as jpack
from spiral_tpu import pir as jpir
from spiral_tpu.core.poly import PolyMat
from spiral_tpu.crypto.decode import response_from_device_rows
from spiral_tpu.crypto.publicparams import PublicParams as JPublicParams
from spiral_tpu.dist import multihost as jmh
from spiral_tpu.dist import shard as jshard
from spiral_tpu.params import preset
from spiral_tpu.server import db as jdb
from spiral_tpu_torch import graft_entry, interop
from spiral_tpu_torch import params as tparams
from spiral_tpu_torch.dist import multihost, shard
from spiral_tpu_torch.pack import (PackClient, PackServer, encode_pack_db,
                                   random_pack_db)
from spiral_tpu_torch.pir import SpiralClient, SpiralServer
from spiral_tpu_torch.server.db import EncodedDb, ShardedDb, encode_db

WORLD = 2
# each rank's join, seconds: a hang fails the module, not the suite
JOIN_S = 120
WORKER = pathlib.Path(__file__).with_name("torch_dist_worker.py")


def _mats(ws):
    return [PolyMat(jnp.asarray(x), True) for x in ws]


def _jax_rows(rows) -> np.ndarray:
    return w.rows_of(response_from_device_rows(*rows))


def _spiral_expected(mesh) -> dict:
    """The JAX mesh servers' rows at tiny: explicit (single, final ct,
    batch of 2) and implicit (single)."""
    p, tp = preset("tiny"), tparams.preset("tiny")
    client = SpiralClient(tp, seed=w.SPIRAL_SEED, device="cpu")
    tpub = client.setup()
    f = interop.public_params_to_numpy(tpub)
    jpub = JPublicParams(W_exp_left=_mats(f["W_exp_left"]),
                         W_exp_right=_mats(f["W_exp_right"]),
                         W_conv=PolyMat(jnp.asarray(f["W_conv"]), True),
                         V=PolyMat(jnp.asarray(f["V"]), True))
    pts = jdb.random_db(p, np.random.default_rng(w.DB_SEED))
    ref = SpiralServer(tp, encode_db(pts, tp, "cpu"), tpub)
    stage_in = []                  # (C_reg, q_pos, q_neg) of each query
    for i in w.QUERY_IDX:
        first_b, gsw_b = ref.query_scalars_batch([client.query(i)])
        stage_in.append([jnp.asarray(interop.to_numpy(x)) for x in
                         (ref.compose(first_b[0]), *ref.convert(gsw_b[0]))])
    srv = jpir.SpiralServer(p, jdb.encode_db(pts, p), jpub, mesh=mesh)
    final = srv._stage_serve_db(srv._db_limbs, *stage_in[0])
    finals_b = jax.jit(srv._fdim_fold_sharded_batch)(
        srv._db_limbs, *[jnp.stack(x) for x in zip(*stage_in)])
    islab = jdb.random_implicit_db(p, np.random.default_rng(w.SLAB_SEED),
                                   max_slab_bytes=w.SLAB_BYTES)
    isrv = jpir.SpiralServer(p, islab, jpub, mesh=mesh)
    return {"pts": pts,
            "spiral_final": np.asarray(final),
            "spiral_rows": _jax_rows(srv._stage_modswitch(final)),
            "spiral_batch_rows": np.stack([
                _jax_rows(srv._stage_modswitch(x)) for x in finals_b]),
            "implicit_chunks": islab.num_chunks,
            "implicit_rows": _jax_rows(srv._stage_modswitch(
                isrv._stage_serve_db(isrv._db_limbs, *stage_in[0])))}


def _pack_expected(mesh) -> dict:
    """The JAX mesh PackServer's rows at tiny_pack: its sharded first dim
    (all-gathered), fold and pack stages."""
    p, tp = preset("tiny_pack"), tparams.preset("tiny_pack")
    client = PackClient(tp, seed=w.PACK_SEED, device="cpu")
    tpub = client.setup()
    f = interop.pack_public_params_to_numpy(tpub)
    jpub = jpack.PackPublicParams(
        v_W=jnp.asarray(f["v_W"]), W_exp_left=_mats(f["W_exp_left"]),
        W_exp_right=_mats(f["W_exp_right"]),
        V=PolyMat(jnp.asarray(f["V"]), True))
    pts = random_pack_db(tp, np.random.default_rng(w.PACK_DB_SEED))
    ref = PackServer(tp, encode_pack_db(pts, tp, "cpu"), tpub)
    first, q_pos, q_neg = (jnp.asarray(interop.to_numpy(x[0])) for x in
                           ref.query_stages_batch([client.query(w.PACK_IDX)]))
    srv = jpack.PackServer(p, jpack.encode_pack_db(pts, p), jpub, mesh=mesh)
    cts = srv._stage_fdim(srv._db_limbs, first)
    return {"pack_rows": _jax_rows(srv._stage_pack(srv._stage_fold(
        cts, q_pos, q_neg)))}


def _small_expected(mesh) -> dict:
    """JAX's psum_mod_pair under a 2-device shard_map and its
    contraction-sharded step."""
    p = preset("tiny")
    psum = jax.jit(jax.shard_map(
        lambda s: jshard.psum_mod_pair(s[0], "db"), mesh=mesh,
        in_specs=P("db"), out_specs=P(), check_vma=False))
    db, qk, qp, qn = w.contraction_inputs(p)
    step = jshard.sharded_firstdim_and_fold(p, mesh)
    return {"psum": np.asarray(psum(jnp.asarray(
                w.psum_inputs(WORLD).astype(np.uint32)))),
            "contraction": np.asarray(step(
                jshard.shard_db(jnp.asarray(db), mesh), jnp.asarray(qk),
                jnp.asarray(qp), jnp.asarray(qn)))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' (arrays, info), JAX's expected values, the ranks' output
    directory): the two ranks run while JAX computes."""
    out = tmp_path_factory.mktemp("dist")
    port = multihost.free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(port), str(WORLD), str(r),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        mesh = jshard.make_db_mesh(jax.devices()[:WORLD])
        want = {**_spiral_expected(mesh), **_pack_expected(mesh),
                **_small_expected(mesh)}
        logs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [(dict(np.load(out / f"rank{r}.npz")),
              json.loads((out / f"rank{r}.json").read_text()))
             for r in range(WORLD)]
    return ranks, want, out


def _case(run, name: str):
    """Each rank's (arrays, info) after case `name`, which must not have
    raised on any rank."""
    ranks, _, _ = run
    for arrays, info in ranks:
        assert f"{name}_error" not in info, info[f"{name}_error"]
    return ranks


@pytest.mark.parametrize("name, world, rank", [
    ("tiny", 2, 0), ("tiny", 2, 1), ("tiny", 4, 3), ("tiny_pack", 1, 0),
    ("tiny", 3, 0)])
def test_row_helpers_match_jax(name, world, rank):
    """host_row_range and host_record_indices equal JAX's; both raise
    ValueError when num_per does not divide by the world."""
    p, tp = preset(name), tparams.preset(name)
    if p.num_per % world:
        for f, args in ((jmh.host_row_range, (p, world, rank)),
                        (multihost.host_row_range, (tp, world, rank)),
                        (multihost.host_record_indices, (tp, world, rank))):
            with pytest.raises(ValueError, match="not divisible"):
                f(*args)
        return
    assert multihost.host_row_range(tp, world, rank) == \
        jmh.host_row_range(p, world, rank)
    np.testing.assert_array_equal(
        multihost.host_record_indices(tp, world, rank),
        jmh.host_record_indices(p, world, rank))


def test_psum_mod_pair_matches_jax(run):
    for arrays, _ in _case(run, "psum"):
        np.testing.assert_array_equal(arrays["psum"], run[1]["psum"])


def test_encode_db_local_is_the_column_block(run):
    """Rank r's encode_db_local block is columns [r*m/2, (r+1)*m/2) of the
    port's encode_db (held to JAX's by test_torch_e2e.py)."""
    tp = tparams.preset("tiny")
    full = encode_db(run[1]["pts"], tp, "cpu").data
    for r, (arrays, _) in enumerate(_case(run, "encode_local")):
        np.testing.assert_array_equal(
            arrays["encode_local"],
            shard.row_block(full, tp.num_per, WORLD, r).numpy())


def test_sharded_spiral_matches_jax_mesh(run):
    """process_query_fused's rows and final_ciphertext equal the JAX mesh
    server's on every rank, decode, and the timings report first dim and
    fold as one stage (folding_us 0), as JAX's mesh server does."""
    want = run[1]
    for arrays, info in _case(run, "spiral"):
        np.testing.assert_array_equal(arrays["spiral_rows"],
                                      want["spiral_rows"])
        np.testing.assert_array_equal(arrays["spiral_final"],
                                      want["spiral_final"])
        assert info["spiral_decodes"]
        assert info["spiral_folding_us"] == 0


def test_sharded_served_in_turn_matches_jax_mesh(run):
    """A mesh server serves through the GraphRunner (eagerly on gloo): two
    different queries in turn through _run_single, a batch of both and
    the second through process_query's stage chain each give the JAX
    mesh server's rows for their query, with first dim and fold one stage
    (folding_us 0)."""
    want = run[1]["spiral_batch_rows"]
    for arrays, info in _case(run, "served"):
        np.testing.assert_array_equal(arrays["served_rows"], want)
        np.testing.assert_array_equal(arrays["served_batch_rows"], want)
        np.testing.assert_array_equal(arrays["served_stages_rows"], want[1])
        assert info["served_folding_us"] == 0
        assert info["served_programs"] == [["batch", False, 2],
                                           ["single", False, 1],
                                           ["stages", False, 1]]


def test_sharded_spiral_batch_matches_jax_mesh(run):
    for arrays, info in _case(run, "spiral"):
        np.testing.assert_array_equal(arrays["spiral_batch_rows"],
                                      run[1]["spiral_batch_rows"])
        assert info["spiral_batch_decodes"]


def test_sharded_pack_matches_jax_mesh(run):
    for arrays, info in _case(run, "pack"):
        np.testing.assert_array_equal(arrays["pack_rows"],
                                      run[1]["pack_rows"])
        assert info["pack_decodes"]


def test_sharded_implicit_matches_jax_mesh(run):
    """4 chunks over 2 ranks: rank 1 streams chunks 2 and 3, its query
    rolled 2 slots first."""
    for arrays, info in _case(run, "implicit"):
        assert info["implicit_chunks"] == run[1]["implicit_chunks"] == 4
        np.testing.assert_array_equal(arrays["implicit_rows"],
                                      run[1]["implicit_rows"])


def test_sharded_implicit_batch_raises(run):
    """The JAX mesh server's batch over an implicit slab raises a TypeError
    (its reshape); the port's raises ValueError before any work."""
    for _, info in _case(run, "implicit"):
        assert "implicit" in info["implicit_batch_error"]


def test_contraction_sharded_fold_matches_jax(run):
    for arrays, _ in _case(run, "contraction"):
        np.testing.assert_array_equal(arrays["contraction"],
                                      run[1]["contraction"])


def test_ingest_and_serve_decodes(run):
    for _, info in _case(run, "ingest"):
        assert info["ingest_decodes"] == [True] * len(w.INGEST_IDX)


def test_dist_figure_rows(run):
    _case(run, "dist_figure")
    rows = json.loads((run[2] / "dist_results.json").read_text())
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["correct"] and r["server_s"] > 0 for r in rows)


def test_dryrun_multichip_two_ranks(run):
    for _, info in _case(run, "dryrun"):
        assert info["dryrun_ok"]


@pytest.fixture(scope="module")
def tiny_inputs():
    """The workers' client, queries, encoded database and implicit slab at
    tiny, made from the same seeds in this process."""
    from spiral_tpu_torch.server.db import random_db, random_implicit_db
    tp = tparams.preset("tiny")
    client = SpiralClient(tp, seed=w.SPIRAL_SEED, device="cpu")
    pub = client.setup()
    db = encode_db(random_db(tp, np.random.default_rng(w.DB_SEED)), tp,
                   "cpu")
    idb = random_implicit_db(tp, np.random.default_rng(w.SLAB_SEED),
                             max_slab_bytes=w.SLAB_BYTES, device="cpu")
    return tp, pub, [client.query(i) for i in w.QUERY_IDX], db, idb


@pytest.mark.parametrize("kind, world", [
    ("single", 2), ("single", 4), ("batch", 2), ("implicit", 2)])
def test_ranks_one_at_a_time_match_jax_mesh(run, tiny_inputs, kind, world):
    """chip_smoke.py's one-rank-at-a-time worlds: each rank a server on
    shard.RankOf (its block, or its chunks with the query rolled), its
    first dim and fold_local; the survivors stacked in rank order and
    fold_tail give the JAX mesh server's rows."""
    from spiral_tpu_torch.crypto.decode import (modswitch_device,
                                                response_from_device_rows,
                                                responses_from_device_rows)
    tp, pub, queries, db, idb = tiny_inputs
    qs = queries if kind == "batch" else queries[:1]
    survivors = []
    for rank in range(world):
        srv = SpiralServer(tp, idb if kind == "implicit" else db, pub,
                           mesh=shard.RankOf(world, rank))
        first_b, gsw_b = srv.query_scalars_batch(qs)
        q_pos, q_neg = srv.convert(gsw_b)
        cts = srv.first_dim_batch(srv.compose(first_b))
        survivors.append(shard.fold_local_batch(cts, q_pos, q_neg, tp))
    if kind == "batch":
        finals = shard.fold_tail_batch(torch.cat(survivors, 1), q_pos, q_neg,
                                       tp)
        got = np.stack([w.rows_of(r) for r in responses_from_device_rows(
            *modswitch_device(finals, tp))])
        np.testing.assert_array_equal(got, run[1]["spiral_batch_rows"])
        return
    final = shard.fold_tail(torch.cat([s[0] for s in survivors]), q_pos[0],
                            q_neg[0], tp)
    got = w.rows_of(response_from_device_rows(*modswitch_device(final, tp)))
    np.testing.assert_array_equal(
        got, run[1]["implicit_rows" if kind == "implicit" else "spiral_rows"])


def test_graft_entry_step_matches_jax():
    """entry()'s step on its inputs equals the JAX entry's step on the same
    residues in the JAX layouts."""
    fn, (db, qk, qp, qn) = graft_entry.entry("cpu")
    got = fn(db, qk, qp, qn)
    tp = tparams.preset("tiny")
    assert tuple(got.shape) == (tp.n1, tp.n2, 2, tp.poly_len)
    jfn, _ = jentry.entry()
    want = jfn(jnp.asarray(interop.encoded_db_to_jax_layout(
        EncodedDb(db, tp))), *(jnp.asarray(interop.to_numpy(x))
                               for x in (qk, qp, qn)))
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("case", ["sharded_db_without_mesh", "chunks",
                                  "implicit_pack"])
def test_mesh_errors(run, case):
    """ValueError, with the JAX package's reasons: a ShardedDb without a
    mesh, implicit chunks that do not divide by the mesh, an implicit pack
    database with a mesh."""
    if case == "sharded_db_without_mesh":
        tp = tparams.preset("tiny")
        block = torch.zeros((2, tp.poly_len, tp.dim0 * tp.n0, tp.n2),
                            dtype=torch.int32)
        with pytest.raises(ValueError, match="requires a mesh"):
            SpiralServer(tp, ShardedDb(block, tp, None), None)
        return
    match = {"chunks": "implicit num_chunks 1 not divisible by mesh size 2",
             "implicit_pack": "implicit pack DB does not support mesh"}
    for _, info in _case(run, "errors"):
        assert info["errors"][case] == match[case]
