"""The serving core every server shares (spiral_tpu_torch/serving.py) on
the CPU at the tiny presets: the served path (_run_single) and a batch of
one give the eager rows, the servers that do not batch refuse, and
last_timings is non-zero in exactly the fields its program's stage names
map to.  No JAX: the eager pipeline is the reference here, and the
comparisons with the JAX servers live in the variants' own test files."""
import dataclasses

import numpy as np
import pytest
import torch

from spiral_tpu_torch import factored, pack, pir, serving
from spiral_tpu_torch.params import preset
from spiral_tpu_torch.server.db import encode_db, random_db

CPU = torch.device("cpu")
SPIRAL_FIELDS = {"expansion_us", "composition_us", "conversion_us",
                 "first_multiply_us", "folding_us", "modswitch_us"}
PACK_FIELDS = {"expansion_us", "conversion_us", "first_multiply_us",
               "folding_us", "packing_us", "modswitch_us"}
TAIL_FIELDS = {"first_multiply_us", "folding_us", "modswitch_us"}


def _spiral():
    p = preset("tiny")
    client = pir.SpiralClient(p, seed=6, device="cpu")
    db = encode_db(random_db(p, np.random.default_rng(7)), p, CPU)
    return client, pir.SpiralServer(p, db, client.setup())


def _pack():
    p = preset("tiny_pack")
    client = pack.PackClient(p, seed=6, device="cpu")
    db = pack.encode_pack_db(pack.random_pack_db(
        p, np.random.default_rng(7)), p, CPU)
    return client, pack.PackServer(p, db, client.setup())


def _factored():
    p = preset("tiny")
    client = pir.SpiralClient(p, seed=6, device="cpu")
    pts = np.random.default_rng(7).integers(
        0, p.p_db, size=(p.total_n, 3, p.n0, p.n2, p.poly_len),
        dtype=np.int64)
    db = factored.encode_factored_db(pts, p, "cpu")
    return client, factored.FactoredSpiralServer(p, db, client.setup())


def _nonzero(t: serving.ServerTimings) -> set:
    return {f.name for f in dataclasses.fields(t) if getattr(t, f.name)}


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("make, fields, batches", [
    (_spiral, SPIRAL_FIELDS, True),
    (_pack, PACK_FIELDS, True),
    (_factored, TAIL_FIELDS, False)], ids=["spiral", "pack", "factored"])
def test_served_rows_and_stage_fields(make, fields, batches):
    """_run_single's rows equal _run_eager's; a batch of one (folded as a
    single query) gives the same rows, or raises ValueError on the
    factored server; the served call's last_timings is non-zero in
    exactly its stage names' fields (the factored server's fused path
    times its tail's three)."""
    client, server = make()
    q = client.query(5)
    eager = [x.clone() for x in server._run_eager(q)]
    assert _equal(server._run_single(q), eager)
    if batches:
        assert _nonzero(server.last_timings) == fields
        resps, seconds = server.process_query_batch([q])
        assert seconds > 0
        assert np.array_equal(resps[0].first_row,
                              eager[0].numpy().astype(np.uint64))
        assert np.array_equal(resps[0].rest_rows,
                              eager[1].numpy().astype(np.uint64))
        assert _equal(server._run_batch([q]), [x[None] for x in eager])
    else:
        with pytest.raises(ValueError):
            server.process_query_batch([q])
        server.process_query_fused(q)
    assert _nonzero(server.last_timings) == fields
    prog = server.graphs.programs[server.graphs.last]
    assert len(prog.stages) == len(fields)


@pytest.mark.parametrize("stages, fields", [
    (pir.SPIRAL_STAGES, SPIRAL_FIELDS),
    (pir.SHARDED_STAGES, SPIRAL_FIELDS - {"folding_us"}),
    (pack.PACK_STAGES, PACK_FIELDS),
    (factored.TAIL_STAGES, TAIL_FIELDS)])
def test_stage_timings_maps_names(stages, fields):
    """One interval a stage name, in its field; a sharded server's
    serve_db in first_multiply_us with folding_us 0."""
    intervals = [float(i + 1) for i in range(len(stages))]
    t = serving.stage_timings(stages, intervals)
    assert _nonzero(t) == fields
    assert t.total_us == sum(intervals)
    if "serve_db" in stages:
        assert t.first_multiply_us == intervals[stages.index("serve_db")]
    with pytest.raises(ValueError):
        serving.stage_timings(stages, intervals[1:])
