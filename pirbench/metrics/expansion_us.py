"""The metric expansion_us: the stage chain's expansion stage, median
microseconds over its runs."""
from pirbench.readers import chain_us


def read(run):
    return chain_us(run, "expansion")
