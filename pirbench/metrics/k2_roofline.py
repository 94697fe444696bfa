"""The metric k2_roofline (and k2_roofline.batch): percent of K2's traced
time that its bound (pirbench/bounds.py) takes."""
from pirbench import bounds
from pirbench.readers import K2_KERNEL, kernel_share


def read(run):
    return kernel_share(run, K2_KERNEL,
                        bounds.k2_s(run.params, run.factor, run.batch))
