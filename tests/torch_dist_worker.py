"""One rank of tests/test_torch_dist.py: the port's scale-out over a gloo
world on the CPU, with jax and the JAX package blocked.

    python tests/torch_dist_worker.py <port> <world> <rank> <out_dir>

Every rank makes the same clients, databases and queries from the seeds
test_torch_dist.py uses, runs each case and writes out_dir/rank<r>.npz
(arrays) and rank<r>.json (a case's error traceback, messages and
flags).  A failing case is recorded and the next one runs.
"""
import json
import pathlib
import sys
import traceback

import numpy as np

# the inputs, shared with test_torch_dist.py
SPIRAL_SEED, DB_SEED, SLAB_SEED = 7, 2, 3
PACK_SEED, PACK_DB_SEED = 3, 4
QUERY_IDX = (1, 14)
PACK_IDX = 5
# tiny: a row of Spiral's slab is n2*K*2*d*4 = 32 KiB: 1 row, 4 chunks
SLAB_BYTES = 32 << 10
INGEST_IDX = (0, 11, 15)
PSUM_SEED, CONTRACTION_SEED = 21, 11


def psum_inputs(world: int) -> np.ndarray:
    """(world, 3, 2, 16) residues within 8 of p - 1."""
    from spiral_tpu_torch.params import B_I, P_I
    x = np.random.default_rng(PSUM_SEED).integers(0, 8, size=(world, 3, 2,
                                                              16))
    return np.array([P_I - 1, B_I - 1]).reshape(2, 1) - x


def contraction_inputs(p):
    """tests/test_sharding.py's draws: db (num_per, n2, K, 2, d), qk (K,
    n1, 2, d), q_pos / q_neg (nu_2, n1, m2, 2, d), uint32 residues."""
    from spiral_tpu_torch.params import B_I, P_I
    d, K = p.poly_len, p.dim0 * p.n0
    rng = np.random.default_rng(CONTRACTION_SEED)
    mods = np.array([P_I, B_I], dtype=np.uint64).reshape(1, 1, 1, 2, 1)
    db = (rng.integers(0, 2**28, size=(p.num_per, p.n2, K, 2, d),
                       dtype=np.uint64) % mods).astype(np.uint32)
    qk = (rng.integers(0, 2**28, size=(K, p.n1, 2, d), dtype=np.uint64) %
          mods.reshape(1, 1, 2, 1)).astype(np.uint32)
    qgs = (rng.integers(0, 2**28, size=(2, p.further_dims, p.n1, p.m2, 2,
                                        d), dtype=np.uint64) %
           mods[None]).astype(np.uint32)
    return db, qk, qgs[0], qgs[1]


def rows_of(resp) -> np.ndarray:
    """A Response of either package -> its rows, flat, int64."""
    return np.concatenate([np.asarray(r, dtype=np.int64).ravel()
                           for r in (resp.first_row, resp.rest_rows)])


def main() -> None:
    # the port runs here with jax and the JAX package blocked
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    sys.modules["jax"] = None
    sys.modules["spiral_tpu"] = None
    import torch

    from spiral_tpu_torch import graft_entry, harness, interop
    from spiral_tpu_torch.dist import multihost, shard
    from spiral_tpu_torch.pack import (PackClient, PackServer,
                                       encode_pack_db, random_pack_db)
    from spiral_tpu_torch.params import preset
    from spiral_tpu_torch.pir import SpiralClient, SpiralServer
    from spiral_tpu_torch.server.db import (encode_db, random_db,
                                            random_implicit_db,
                                            random_implicit_pack_db)

    port, world, rank, out = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), pathlib.Path(sys.argv[4])
    torch.set_num_threads(2)
    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    mesh = shard.make_db_mesh(device="cpu")
    arrays, info = {}, {}

    def case(name):
        def run(fn):
            try:
                fn()
            except Exception:
                info[f"{name}_error"] = traceback.format_exc()
        return run

    p = preset("tiny")
    client = SpiralClient(p, seed=SPIRAL_SEED, device="cpu")
    pub = client.setup()
    pts = random_db(p, np.random.default_rng(DB_SEED))
    db = encode_db(pts, p, "cpu")
    queries = [client.query(i) for i in QUERY_IDX]

    @case("psum")
    def _():
        x = torch.from_numpy(psum_inputs(world)[rank].astype(np.int32))
        arrays["psum"] = shard.psum_mod_pair(x, mesh.get_group()).numpy()

    @case("encode_local")
    def _():
        idx = multihost.host_record_indices(p, world, rank)
        arrays["encode_local"] = multihost.encode_db_local(
            pts[idx], p, "cpu").numpy()

    @case("spiral")
    def _():
        server = SpiralServer(p, db, pub, mesh=mesh)
        resp, _ = server.process_query_fused(queries[0])
        arrays["spiral_rows"] = rows_of(resp)
        info["spiral_decodes"] = bool(np.array_equal(
            client.decode(resp), pts[QUERY_IDX[0]].astype(object)))
        arrays["spiral_final"] = server.final_ciphertext(queries[0]).numpy()
        _, tm = server.process_query(queries[0])
        info["spiral_folding_us"] = tm.folding_us
        resps, _ = server.process_query_batch(queries)
        arrays["spiral_batch_rows"] = np.stack([rows_of(r) for r in resps])
        info["spiral_batch_decodes"] = all(
            np.array_equal(client.decode(r), pts[i].astype(object))
            for r, i in zip(resps, QUERY_IDX))

    @case("served")
    def _():
        # two queries in turn through the runner, then a batch and the
        # stage chain, on one mesh server
        server = SpiralServer(p, db, pub, mesh=mesh)
        arrays["served_rows"] = np.stack([rows_of(server._response(
            *server._run_single(q))) for q in queries])
        resps, _ = server.process_query_batch(queries)
        arrays["served_batch_rows"] = np.stack([rows_of(r) for r in resps])
        resp, tm = server.process_query(queries[1])
        arrays["served_stages_rows"] = rows_of(resp)
        info["served_folding_us"] = tm.folding_us
        info["served_programs"] = sorted(map(list, server.graphs.programs))

    @case("pack")
    def _():
        pp = preset("tiny_pack")
        pc = PackClient(pp, seed=PACK_SEED, device="cpu")
        ppts = random_pack_db(pp, np.random.default_rng(PACK_DB_SEED))
        server = PackServer(pp, encode_pack_db(ppts, pp, "cpu"), pc.setup(),
                            mesh=mesh)
        resp, _ = server.process_query_fused(pc.query(PACK_IDX))
        arrays["pack_rows"] = rows_of(resp)
        info["pack_decodes"] = bool(np.array_equal(
            pc.decode(resp), ppts[PACK_IDX].astype(object)))

    @case("implicit")
    def _():
        idb = random_implicit_db(p, np.random.default_rng(SLAB_SEED),
                                 max_slab_bytes=SLAB_BYTES, device="cpu")
        info["implicit_chunks"] = idb.num_chunks
        server = SpiralServer(p, idb, pub, mesh=mesh)
        arrays["implicit_rows"] = rows_of(
            server.process_query_fused(queries[0])[0])
        try:
            server.process_query_batch(queries)
        except ValueError as e:
            info["implicit_batch_error"] = str(e)

    @case("contraction")
    def _():
        dbu, qk, qp, qn = contraction_inputs(p)
        data = interop.encoded_db(dbu, p, "cpu").data
        step = shard.sharded_firstdim_and_fold(p, mesh)
        arrays["contraction"] = step(
            shard.shard_db(data, mesh), interop.to_torch(qk, "cpu"),
            interop.to_torch(qp, "cpu"), interop.to_torch(qn, "cpu")).numpy()

    @case("ingest")
    def _():
        server = multihost.ingest_and_serve(lambda idx: pts[idx], p, pub,
                                            device="cpu")
        info["ingest_decodes"] = [
            bool(np.array_equal(client.decode(server.process_query(
                client.query(i))[0]), pts[i].astype(object)))
            for i in INGEST_IDX]

    @case("dist_figure")
    def _():
        harness.main(["dist", "--tiny", "--devices", "1,2", "--device",
                      "cpu", "--results-dir", str(out)])

    @case("dryrun")
    def _():
        graft_entry.dryrun_multichip(2, "cpu")
        info["dryrun_ok"] = True

    @case("errors")
    def _():
        messages = {}
        one_chunk = random_implicit_db(p, np.random.default_rng(SLAB_SEED),
                                       device="cpu")
        pp = preset("tiny_pack")
        pack_slab = random_implicit_pack_db(
            pp, np.random.default_rng(SLAB_SEED), device="cpu")
        for name, make in (
                ("chunks", lambda: SpiralServer(p, one_chunk, pub,
                                                mesh=mesh)),
                ("implicit_pack", lambda: PackServer(pp, pack_slab, None,
                                                     mesh=mesh))):
            try:
                make()
            except ValueError as e:
                messages[name] = str(e)
        info["errors"] = messages

    np.savez(out / f"rank{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(info))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
