"""The benchmark's spiral_18_30000 configuration (pirbench/configs/): its
params and factor are the port's own selection for 2^18 records of
30,000 B, its encoded database's bytes follow from the file, and its
gadgets and moduli (F 4, t_exp 32, t_exp_right 56, t_gsw 9, q' 23) serve
through the benchmark's System on a CPU server: every answer of the single
path and of the stage chain decodes to its record through the plain
reference client, and the configuration's control does not."""
from pirbench.cell import load_config, run_cell
from pirbench.reference.scheme import SchemeParams
from pirbench.workload import Traffic

CONFIG = load_config("spiral_18_30000")
SEED = 2**31 + 11
# the single mix cut to a few steps, traced so that the stage chain runs
SHORT = Traffic(name="single", loop="closed", batch=1, pool=8,
                warm_steps=2, trace_steps=2, chain_runs=3)
CONTROL = Traffic(name="single", loop="closed", batch=1, pool=2,
                  warm_steps=2, trace_steps=0, chain_runs=0)


def small(poly_len: int) -> dict:
    """The configuration's gadgets, moduli and factor on a small database:
    nu_2 1 and nu_1 4, the least that keep stopround > 0 at t_gsw 9 (the
    configuration's stopround 7 expansion)."""
    fields = dict(CONFIG["params"], poly_len=poly_len, nu_1=4, nu_2=1)
    assert SchemeParams.from_config(fields).stopround > 0
    return {"params": fields, "factor": CONFIG["factor"]}


def test_params_are_the_ports_selection():
    from spiral_tpu_torch.paramgen.search import select_params
    sel = select_params(18, 30_000)
    assert {f: getattr(sel.params, f) for f in CONFIG["params"]} == \
        CONFIG["params"]
    assert sel.factor == CONFIG["factor"] == 4


def test_encoded_bytes_follow_from_the_file():
    db = CONFIG["database"]
    p = SchemeParams.from_config(CONFIG["params"])
    F = CONFIG["factor"]
    assert db["rows"] == p.total_n == db["records"] == 2**18
    # a row: F sub-database rows of n0 x n2 polys of d coefficients mod
    # p_db, one byte each at p_db 256
    coeffs = db["rows"] * F * p.n0 * p.n2 * p.poly_len
    assert coeffs * (p.p_db.bit_length() - 1) // 8 == db["item_slot_bytes"]
    assert db["item_slot_bytes"] >= db["records"] * db["record_bytes"]
    # encoded: two CRT words of 4 bytes a coefficient, in K2's layout (2,
    # d, dim0*n0, F*num_per*n2)
    shape = (2, p.poly_len, p.dim0 * p.n0, F * p.num_per * p.n2)
    assert shape == (2, 2048, 2048, 2048)
    assert 4 * shape[0] * shape[1] * shape[2] * shape[3] == coeffs * 8 == \
        68_719_476_736


def test_served_answers_decode():
    """The single path (pir.serve_single) in the warm-up, window and
    traced steps, and the stage chain (process_query), at d = 256."""
    out = run_cell(small(256), SHORT, SEED, 0.2, True, "cpu", 0.0)
    run = out["run"]
    assert out["check"]["wrong_answers"] == 0
    assert out["attempted"] == SHORT.warm_steps + len(run.steps) + \
        SHORT.trace_steps + SHORT.chain_runs
    assert len(run.chain) == SHORT.chain_runs - 1


def test_control_reads_wrong():
    """The configuration's control (a 16-bit q') at the configuration's
    ring, d = 2048: at d = 256 the row-0 rounding noise of a 16-bit q'
    stays far under half a plaintext step and every answer decodes."""
    override = {k: v for k, v in CONFIG["control"].items() if k != "why"}
    out = run_cell(small(2048), CONTROL, SEED, 0.0, False, "cpu", 0.0,
                   params_override=override)
    assert out["check"]["answers"] == CONTROL.warm_steps
    assert out["check"]["wrong_answers"] == out["check"]["answers"]
