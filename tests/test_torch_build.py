"""kernels.build with a stand-in nvcc (a shell script that writes its -o
file and fails on the sources it is told to): the library appears only
when every compile and the link succeed, and no object or temporary file
is left behind either way.  Runs without CUDA."""
import stat

import pytest

from spiral_tpu_torch import kernels

FAKE_NVCC = """#!/bin/sh
out=""; fail=""
while [ $# -gt 0 ]; do
  [ "$1" = -o ] && out="$2"
  case "$1" in *"$FAIL_ON"*) [ -n "$FAIL_ON" ] && fail=1 ;; esac
  shift
done
echo built > "$out"
[ -z "$fail" ]
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", build_dir)
    return build_dir


@pytest.mark.parametrize("fail_on", ["", "fold.cu", "-shared"])
def test_build_leaves_only_the_library(fake_build, monkeypatch, fail_on):
    monkeypatch.setenv("FAIL_ON", fail_on)
    if fail_on:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kernels.build()
        assert list(fake_build.iterdir()) == []
    else:
        so = kernels.build()
        assert [p.name for p in fake_build.iterdir()] == [so.name]
        assert kernels.build() == so       # built once, then found
