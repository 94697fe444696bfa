"""The metric idle_pct (and idle_pct.batch): percent of an untraced
step's wall time in which the card runs nothing.  The card's busy seconds
a step (kernels and copies) come from the traced window's timeline, the
step's seconds from the untraced window: tracing stretches a step's gaps,
not its kernels, so the traced window's own idle share reads long."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.trace_steps \
            or not run.steps:
        return None
    busy = run.trace.busy_s / run.trace_steps
    return 100.0 * (1.0 - busy / (run.window_s / len(run.steps)))
