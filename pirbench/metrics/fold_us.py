"""The metric fold_us: the stage chain's fold stage, median
microseconds over its runs."""
from pirbench.readers import chain_us


def read(run):
    return chain_us(run, "fold")
