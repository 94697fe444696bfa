import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

# Tests run on the CPU backend with 8 virtual devices so sharding paths are
# exercised without a pod (SURVEY.md section 4 note on multi-host testing).
# SPIRAL_TEST_TPU=1 keeps the real backend so hardware-only paths (the
# Mosaic-compiled Pallas kernels) get unit-test coverage on a TPU machine.
if not os.environ.get("SPIRAL_TEST_TPU"):
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
