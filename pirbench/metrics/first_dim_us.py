"""The metric first_dim_us: the stage chain's first_dim stage, median
microseconds over its runs."""
from pirbench.readers import chain_us


def read(run):
    return chain_us(run, "first_dim")
