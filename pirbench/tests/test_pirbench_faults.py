"""`correct` comes out false for the control and for each fault a cell can
have, with the rest of a run driven as the benchmark drives it (the look
for a card skipped, the CPU server in the card's place)."""
import numpy as np
import pytest

from pirbench import check, run as runmod
from pirbench.cell import draw_records, run_cell
from pirbench.reference.client import PlainClient
from pirbench.reference.scheme import SchemeParams
from pirbench.tests.conftest import (BATCH, SINGLE, TINY_CONTROL,
                                     tiny_config)
from spiral_tpu_torch import pir

BENCH_CELL = {"name": "tiny.cell", "chips": 1}
BENCH = {"end_to_end": [{"name": "latency_p50_ms", "unit": "ms"}],
         "per_layer": []}


def correct(out) -> bool:
    return runmod.result_line(BENCH, BENCH_CELL, out, False,
                              "cpu")["correct"]


def test_sound_run_is_correct(t0):
    out = run_cell(tiny_config(), SINGLE, 11, 0.2, False, "cpu", t0)
    line = runmod.result_line(BENCH, BENCH_CELL, out, False, "cpu")
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["checks"] == {"wrong_answers": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("factor", [1, 3])
def test_control_is_not_correct(factor, t0):
    """The control: the response's first row switched to a 14-bit q' (the
    tiny configuration's control), program and client alike."""
    out = run_cell(tiny_config(factor), SINGLE, 12, 0.2, False, "cpu", t0,
                   params_override=TINY_CONTROL)
    assert not correct(out)
    assert out["check"]["wrong_answers"] > 0


def _fold_skipped(cts_coeff, q_pos, q_neg, params, **kw):
    return cts_coeff[0]


def _batch_fold_skipped(cts_b, q_pos_b, q_neg_b, params, **kw):
    return cts_b[:, :1]


def _altered(modswitch):
    """One coefficient of the answer's last rows moved by half their
    modulus 4p where the modulus switch produces it (a step of 1 in row 0
    is within the decode's noise margin, so it would alter no record)."""
    def wrapped(final, params):
        first, rest = modswitch(final, params)
        rest = rest.clone()
        q1 = 4 * params.p_db
        rest.view(-1)[0] = (rest.view(-1)[0] + q1 // 2) % q1
        return first, rest
    return wrapped


def _half_batch(serve):
    def wrapped(self, queries):
        half = queries[:len(queries) // 2]
        resps, seconds = serve(self, half)
        return resps + resps[:len(queries) - len(half)], seconds
    return wrapped


# a single query has no half to leave out; one card, no exchange between
# cards to leave out
@pytest.mark.parametrize("fault, traffic", [
    ("state_unchanged", SINGLE), ("answer_altered", SINGLE),
    ("state_unchanged", BATCH), ("answer_altered", BATCH),
    ("half_batch", BATCH)],
    ids=["single-state_unchanged", "single-answer_altered",
         "batch-state_unchanged", "batch-answer_altered", "batch-half_batch"])
def test_planted_fault_is_not_correct(fault, traffic, monkeypatch, t0):
    if fault == "state_unchanged":
        # the fold's rounds leave their input as it was
        monkeypatch.setattr(pir, "fold_ciphertexts", _fold_skipped)
        monkeypatch.setattr(pir, "fold_rounds_batch", _batch_fold_skipped)
    elif fault == "answer_altered":
        monkeypatch.setattr(pir, "modswitch_device",
                            _altered(pir.modswitch_device))
    else:
        monkeypatch.setattr(pir.SpiralServer, "process_query_batch",
                            _half_batch(pir.SpiralServer.process_query_batch))
    out = run_cell(tiny_config(), traffic, 13, 0.2, False, "cpu", t0)
    assert not correct(out)


def test_flipped_word_is_wrong():
    """A response with one word of its bytes flipped is judged wrong, and
    only that answer."""
    from pirbench.reference import wire
    from pirbench.system import System

    sp = SchemeParams.from_config(tiny_config()["params"])
    records = draw_records(sp, 1, 14, "cpu", np.int16)
    client = PlainClient(sp, 14)
    system = System(tiny_config()["params"], records, 1,
                    wire.public_params_to_bytes(client.public_params()),
                    "cpu")
    idxs = [3, 9]
    out, _ = system.step([wire.query_to_bytes(q)
                          for q in client.queries(idxs[:1])])
    out2, _ = system.step([wire.query_to_bytes(q)
                           for q in client.queries(idxs[1:])])
    good = [(idxs[0], out[0]), (idxs[1], out2[0])]
    assert check.check_answers(client, records, good,
                               "cpu")["wrong_answers"] == 0
    for pos in (10, len(out[0][0]) - 5):
        b = bytearray(out[0][0])
        b[pos] ^= 0xFF
        bad = [(idxs[0], [bytes(b)]), (idxs[1], out2[0])]
        assert check.check_answers(client, records, bad,
                                   "cpu")["wrong_answers"] == 1
