"""What more than one metric file under metrics/ reads from a finished run
(a cell.Run).  Each returns a number, or None where the run holds nothing
to read: the harness then leaves the metric out of the result line.
"""
from __future__ import annotations

import statistics

# the kernels' names in the profiler trace (csrc/firstdim.cu, csrc/fold.cu)
K2_KERNEL = "firstdim_kernel"
FOLD_KERNEL = "fold_round_kernel"


def chain_us(run, *stages):
    """The median over the stage chain's runs of the stages' summed
    microseconds."""
    if not run.chain:
        return None
    return statistics.median(sum(c[s] for s in stages) for c in run.chain)


def kernel_share(run, kernel: str, bound_step_s: float):
    """Percent of the kernel's traced time its bound takes, over the
    traced steps."""
    if run.trace is None:
        return None
    n, seconds = run.trace.kernel_time(kernel)
    if not n or seconds <= 0:
        return None
    return 100.0 * run.trace_steps * bound_step_s / seconds
