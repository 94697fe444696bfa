"""The metric latency_p95_ms: the 95th percentile of the latency over
every query of the window (numpy's linear interpolation), in
milliseconds."""
import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies), 95)) * 1e3
