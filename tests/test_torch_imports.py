"""spiral_tpu_torch and every submodule import with jax blocked."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
sys.modules['jax'] = None
import importlib, pkgutil
import spiral_tpu_torch
names = [m.name for m in pkgutil.walk_packages(spiral_tpu_torch.__path__,
                                               'spiral_tpu_torch.')]
for name in names:
    importlib.import_module(name)
assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]
print(len(names))
"""


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
