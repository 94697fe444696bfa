"""The metric latency_p50_ms: the median latency over every query of the
window, in milliseconds."""
import statistics


def read(run):
    return statistics.median(run.latencies) * 1e3 if run.latencies else None
