"""spiral_tpu_torch, every submodule and chip_smoke import with jax and the
JAX package blocked: the port keeps its own copy of what it needs."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
sys.modules['jax'] = None
sys.modules['spiral_tpu'] = None
import importlib, pkgutil
import spiral_tpu_torch
names = [m.name for m in pkgutil.walk_packages(spiral_tpu_torch.__path__,
                                               'spiral_tpu_torch.')]
for name in names + ['chip_smoke']:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items() if v is not None and (
    k.split('.')[0] in ('jax', 'jaxlib', 'spiral_tpu'))]
assert not loaded, loaded
print(' '.join(names))
"""


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert len(names) >= 25
    assert {f"spiral_tpu_torch.{m}" for m in
            ("native", "serialize", "factored", "profiling", "bench",
             "harness", "paramgen.search", "select_params", "run_scheme",
             "output_params", "dist.shard", "dist.multihost",
             "graft_entry", "graphs")} <= set(names)
