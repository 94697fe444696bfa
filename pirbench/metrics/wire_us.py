"""The metric wire_us (and wire_us.batch): host microseconds per query
spent parsing its bytes and packing its responses' bytes, the median over
the window's steps."""
import statistics


def read(run):
    if not run.steps:
        return None
    return statistics.median((parse + pack) / b * 1e6
                             for parse, _, pack, b in run.steps)
