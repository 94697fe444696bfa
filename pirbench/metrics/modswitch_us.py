"""The metric modswitch_us: the stage chain's modswitch stage, median
microseconds over its runs."""
from pirbench.readers import chain_us


def read(run):
    return chain_us(run, "modswitch")
