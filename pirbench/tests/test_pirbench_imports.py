"""Every pirbench module imports with jax and the JAX package blocked (the
benchmark never loads them), and the plain reference imports with the
program blocked too (it takes nothing of the port)."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "pirbench"


def modules(folder: Path) -> list[str]:
    names = []
    for f in sorted(folder.rglob("*.py")):
        rel = f.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or "metrics" in rel.parts:
            continue
        names.append(".".join(rel.parts))
    return names


BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def __init__(self, names): self.names = names
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block({blocked!r}))
import importlib
for m in {mods!r}:
    importlib.import_module(m)
from pirbench import run
for f in {metrics!r}:
    run.load_metric(f)
print(sorted({{n.split(".")[0] for n in sys.modules}} & set({blocked!r})))
"""


def run_blocked(blocked: list, mods: list, metrics: list) -> str:
    code = BLOCK.format(blocked=blocked, mods=mods, metrics=metrics)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_benchmark_imports_without_jax():
    metrics = sorted(f.name[:-3] for f in (PKG / "metrics").glob("*.py"))
    assert run_blocked(["jax", "jaxlib", "flax", "spiral_tpu"],
                       modules(PKG), metrics) == "[]"


def test_reference_imports_without_the_program():
    mods = modules(PKG / "reference") + ["pirbench.check",
                                         "pirbench.workload",
                                         "pirbench.bounds"]
    assert run_blocked(["jax", "jaxlib", "flax", "spiral_tpu",
                        "spiral_tpu_torch"], mods, []) == "[]"


@pytest.mark.parametrize("name", ["spiral_tpu", "jax"])
def test_forbidden_check_compares_whole_names(name, monkeypatch):
    from pirbench import run
    assert name not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, f"{name}.fake", object())
    assert name in run.loaded_forbidden()
