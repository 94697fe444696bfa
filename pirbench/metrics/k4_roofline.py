"""The metric k4_roofline: percent of K4's traced time (the expansion's
key switches) that its bound takes: one query's summed bound
(pirbench/expand_bounds.py) times the queries of a step, over the traced
steps."""
from pirbench import expand_bounds
from pirbench.readers import kernel_share

# the kernel's name in the profiler trace (csrc/expand.cu)
K4_KERNEL = "expand_keyswitch_kernel"


def read(run):
    return kernel_share(run, K4_KERNEL,
                        expand_bounds.k4_s(run.params) * run.batch)
