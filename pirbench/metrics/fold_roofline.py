"""The metric fold_roofline (and fold_roofline.batch): percent of the
fold kernels' traced time that their summed bound (pirbench/bounds.py)
takes."""
from pirbench import bounds
from pirbench.readers import FOLD_KERNEL, kernel_share


def read(run):
    return kernel_share(run, FOLD_KERNEL,
                        bounds.fold_s(run.params, run.factor, run.batch))
