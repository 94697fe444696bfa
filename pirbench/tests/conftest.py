"""Shared inputs of the benchmark's CPU tests: the `tiny` parameters (d =
256, 16 rows) as a configuration, and short closed-loop mixes."""
import time

import pytest

from pirbench.workload import Traffic

TINY = {"nu_1": 2, "nu_2": 2, "p_db": 256, "q_prime_bits": 20, "t_gsw": 8,
        "t_conv": 4, "t_exp": 8, "t_exp_right": 8, "poly_len": 256,
        "n0": 2, "n1": 3, "n2": 2, "out_n": 2, "query_elems_first": 1,
        "query_elems_rest": 0, "ternary": False, "seed": 0}
# at d = 256 a 14-bit q' (12289) leaves the row-0 rounding noise at about
# a quarter of a plaintext step: many coefficients decode wrong
TINY_CONTROL = {"q_prime_bits": 14}


def tiny_config(factor: int = 1) -> dict:
    return {"params": dict(TINY), "factor": factor}


SINGLE = Traffic(name="single", loop="closed", batch=1, pool=12,
                 warm_steps=2, trace_steps=2, chain_runs=3)
BATCH = Traffic(name="batch4", loop="closed", batch=4, pool=12,
                warm_steps=1, trace_steps=1, chain_runs=0)


@pytest.fixture
def t0():
    return time.perf_counter()
