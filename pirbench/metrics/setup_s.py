"""The metric setup_s: seconds from the process's start to the window's
start, less the benchmark's own client making its keys, public parameters
and queries (cell.run_cell)."""


def read(run):
    return run.setup_s
