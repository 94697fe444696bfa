"""The metric throughput_qps: queries answered over the window's
seconds."""


def read(run):
    return len(run.latencies) / run.window_s if run.window_s else None
