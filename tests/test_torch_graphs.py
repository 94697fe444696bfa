"""The port's served path (spiral_tpu_torch/graphs.py's staged runner) on a
CPU server at the tiny presets, where it runs its body eagerly on the
staged inputs and clones its static outputs as a CUDA-graph replay does:
distinct queries enqueued back to back and fetched only at the end each
get their own rows (no stale input, no aliased output), equal to the
eager stages' rows and, at tiny, to one JAX SpiralServer's one-dispatch
_run_single; batches served twice and two batch sizes in one server; the
factored server's served tail.  All arithmetic is exact: the tolerance is
0.  The capture itself runs only on the card (chip_smoke.py).  Torch runs
one intra-op thread in this module (restored after it): the tiny
presets' ops gain nothing from more, and the suite's parallel workers
share the cores."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiral_tpu import pir as jpir
from spiral_tpu.core.poly import PolyMat
from spiral_tpu.crypto.publicparams import PublicParams as JPublicParams
from spiral_tpu.crypto.query import Query as JQuery
from spiral_tpu.params import preset as jpreset
from spiral_tpu.server.db import encode_db as j_encode_db
from spiral_tpu_torch import factored, graphs, interop
from spiral_tpu_torch.pack import (PackClient, PackServer, encode_pack_db,
                                   random_pack_db)
from spiral_tpu_torch.params import preset
from spiral_tpu_torch.pir import SpiralClient, SpiralServer
from spiral_tpu_torch.server.db import encode_db, random_db

PRESETS = ("tiny", "tiny_pack", "tiny_stream", "tiny_stream_pack")
IDXS = (0, 5, 9, 15)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _serve(name: str):
    """(client, server, records) at `name`, on the CPU."""
    p = preset(name)
    pack = "pack" in name
    client = (PackClient if pack else SpiralClient)(p, seed=6, device="cpu")
    pts = (random_pack_db if pack else random_db)(p,
                                                  np.random.default_rng(7))
    encode = encode_pack_db if pack else encode_db
    server = (PackServer if pack else SpiralServer)(
        p, encode(pts, p, CPU), client.setup())
    return client, server, pts


def _equal_rows(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", PRESETS)
def test_pipelined_queries_get_their_own_rows(name):
    """Four distinct queries through _run_single, every response fetched
    only after the last is enqueued: each equals its query's eager rows
    and decodes to its record; the runner holds one program, whose static
    outputs no response aliases."""
    client, server, pts = _serve(name)
    queries = [client.query(i) for i in IDXS]
    direct = queries[0].packed_b is None
    assert direct == ("stream" in name)
    outs = [server._run_single(q) for q in queries]
    for i, q, rows in zip(IDXS, queries, outs):
        assert _equal_rows(rows, server._run_eager(q)), i
        np.testing.assert_array_equal(
            client.decode(server._response(*rows)), pts[i].astype(object))
    assert not torch.equal(outs[0][1], outs[1][1])
    prog = server.graphs.programs[("single", direct, 1)]
    assert list(server.graphs.programs) == [("single", direct, 1)]
    assert prog.graph is None and server.serving == "eager"
    static = {t.data_ptr() for t in prog.outputs}
    assert not static & {t.data_ptr() for rows in outs for t in rows}
    # the staged inputs hold the last query's b rows
    want = queries[-1].packed_b if not direct else torch.cat(
        [queries[-1].first_b, queries[-1].gsw_b])
    assert torch.equal(prog.inputs[1][0], want)


@pytest.mark.parametrize("name", PRESETS)
def test_batches_served_twice_and_two_sizes(name):
    """A batch of 2 served twice gives its eager rows both times; a batch
    of 3 in the same server gets a program of its own; every answer
    decodes, and each call's stage split (the runner's own eager run,
    marked, on the CPU) is in last_batch_timings."""
    client, server, pts = _serve(name)
    queries = [client.query(i) for i in IDXS]
    direct = queries[0].packed_b is None
    first, _ = server.process_query_batch(queries[:2])
    timings = server.last_batch_timings
    again, seconds = server.process_query_batch(queries[:2])
    assert seconds > 0 and timings.total_us > 0
    assert server.last_batch_timings is not timings
    eager = server._run_batch(queries[:2])
    for b, resp in enumerate(first):
        assert all(np.array_equal(x, interop.to_numpy(e[b]).astype(object))
                   for x, e in zip(interop.response_rows(resp), eager))
    for a, b in zip(first, again):
        for x, y in zip(interop.response_rows(a), interop.response_rows(b)):
            np.testing.assert_array_equal(x, y)
    three, _ = server.process_query_batch(queries[1:])
    assert set(server.graphs.programs) == {("batch", direct, 2),
                                           ("batch", direct, 3)}
    for i, resp in zip(IDXS[:2] + IDXS[1:], first + three):
        np.testing.assert_array_equal(client.decode(resp),
                                      pts[i].astype(object))
    server.release_graphs()
    assert not server.graphs.programs


def _jax_pub(tpub) -> JPublicParams:
    """A JAX PublicParams of the port's arrays."""
    f = interop.public_params_to_numpy(tpub)
    mats = [[PolyMat(jnp.asarray(w), True) for w in f[k]]
            for k in ("W_exp_left", "W_exp_right")]
    return JPublicParams(W_exp_left=mats[0], W_exp_right=mats[1],
                         W_conv=PolyMat(jnp.asarray(f["W_conv"]), True),
                         V=PolyMat(jnp.asarray(f["V"]), True))


def test_tiny_rows_equal_jax_run_single():
    """Four of the port client's queries through _run_single back to back:
    each query's rows equal one JAX SpiralServer's _run_single rows (its
    one-dispatch full_packed program) over the same records and public
    parameters."""
    client, server, pts = _serve("tiny")
    jp = jpreset("tiny")
    jserver = jpir.SpiralServer(jp, j_encode_db(pts, jp),
                                _jax_pub(server.pub))
    queries = [client.query(i) for i in IDXS]
    outs = [server._run_single(q) for q in queries]
    for q, rows in zip(queries, outs):
        f = interop.query_to_numpy(q)
        want = jserver._run_single(JQuery(
            seed=f["seed"], packed_b=jnp.asarray(f["packed_b"])))
        for got, w in zip(rows, want):
            np.testing.assert_array_equal(interop.to_numpy(got),
                                          np.asarray(w))


def test_factored_served_tail():
    """A factored server's process_query_fused serves its tail (first dim,
    fold, modulus switch) through the runner on the query stages' staged
    outputs: two queries in turn, each equal to its process_query rows and
    decoded chunk by chunk; _run_single serves the whole query."""
    tp = preset("tiny")
    client = SpiralClient(tp, seed=4, device="cpu")
    pts = np.random.default_rng(5).integers(
        0, tp.p_db, size=(tp.total_n, 3, tp.n0, tp.n2, tp.poly_len))
    server = factored.FactoredSpiralServer(
        tp, factored.encode_factored_db(pts, tp, "cpu"), client.setup())
    for idx in (IDXS[1], IDXS[3]):
        q = client.query(idx)
        got, seconds = server.process_query_fused(q)
        want, _ = server.process_query(q)
        assert seconds > 0 and len(got) == 3
        for a, b in zip(got, want):
            for x, y in zip(interop.response_rows(a),
                            interop.response_rows(b)):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(factored.decode_factored(client, got),
                                      pts[idx].astype(object))
        assert _equal_rows(server._run_single(q), server._run_eager(q))
    assert set(server.graphs.programs) == {("tail", False, 1),
                                           ("single", False, 1)}


def test_staging_refuses_what_it_cannot_serve():
    """A batch that mixes forms, an empty batch and parts that do not fill
    their static input raise ValueError."""
    client, server, _ = _serve("tiny")
    sclient, _, _ = _serve("tiny_stream")
    with pytest.raises(ValueError, match="mixes"):
        server.process_query_batch([client.query(1), sclient.query(1)])
    with pytest.raises(ValueError, match="empty"):
        server.process_query_batch([])
    staged = graphs.Staged((3, 2), [torch.zeros(2, 2, dtype=torch.int32)])
    with pytest.raises(ValueError, match="staged rows"):
        graphs.static_inputs([staged], CPU)
