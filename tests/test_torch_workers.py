"""Torch's threads in a pytest-xdist worker.

The workers share the host's cores, so each worker's torch takes its share
of them: workers that each ran torch's intra-op pool over every core would
oversubscribe the cores several times over.  Every worker collects every
test module before it runs a test, so setting the count when this module
is imported reaches each worker's tests.
"""
import os

import torch

WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")


def worker_threads(cpus: int, workers: int) -> int:
    """Torch threads for each of `workers` workers on `cpus` cores."""
    return max(1, cpus // workers)


if WORKERS:
    torch.set_num_threads(worker_threads(os.cpu_count() or 1, int(WORKERS)))


def test_worker_threads():
    assert [worker_threads(c, w) for c, w in ((8, 6), (32, 6), (4, 8))] == \
        [1, 5, 1]
    if WORKERS:
        assert torch.get_num_threads() == worker_threads(os.cpu_count() or 1,
                                                         int(WORKERS))
