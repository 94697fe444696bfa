"""How `correct` is decided: every answer the run got back is decoded by
the benchmark's own plain client and compared with the record the
benchmark made, exactly.

An answer is the response bytes of one query (F responses over a factored
database).  A response decodes to its record's n0 x n2 x d plaintext mod
p; the answer is wrong if any of its responses is malformed (another
length than the parameters give) or decodes to anything else than the
record.  Equal bytes decode equally, so each distinct response is decoded
once and its verdict holds for every copy.  The configuration states that
every answer decodes exactly, so the limit of wrong answers is 0.
"""
from __future__ import annotations

import math

import numpy as np

from .reference import wire

# answers decoded per block, so that the decode's memory stays small
DECODE_BLOCK = 512
LIMITS = {"wrong_answers": 0}


def response_length(p) -> int:
    qp_bits, q1_bits = p.response_widths
    first = math.ceil(p.n2 * p.poly_len * qp_bits / 8)
    return 4 + first + math.ceil(p.n0 * p.n2 * p.poly_len * q1_bits / 8)


def check_answers(client, records: list, answers: list, device) -> dict:
    """records: the F sub-databases (total_n, n0, n2, d); answers: (record
    index, [F response bytes]) for every query served.  -> {"answers",
    "wrong_answers"}."""
    p = client.params
    want_len = response_length(p)
    verdict = {}                                  # (idx, f, bytes) -> ok
    todo = []
    for idx, resps in answers:
        if len(resps) != len(records):
            continue
        for f, b in enumerate(resps):
            key = (idx, f, b)
            if key in verdict:
                continue
            if len(b) != want_len or int.from_bytes(b[:4], "little") != \
                    math.ceil(p.n2 * p.poly_len * p.q_prime_bits / 8):
                verdict[key] = False
            else:
                verdict[key] = None
                todo.append(key)
    for k0 in range(0, len(todo), DECODE_BLOCK):
        block = todo[k0:k0 + DECODE_BLOCK]
        rows = [wire.response_from_bytes(b, p) for _, _, b in block]
        got = client.decode(np.stack([r[0] for r in rows]),
                            np.stack([r[1] for r in rows]), device)
        for key, g in zip(block, got):
            idx, f, _ = key
            verdict[key] = bool(np.array_equal(g, records[f][idx]))
    wrong = sum(1 for idx, resps in answers
                if len(resps) != len(records) or
                not all(verdict[(idx, f, b)] for f, b in enumerate(resps)))
    return {"answers": len(answers), "wrong_answers": wrong}
