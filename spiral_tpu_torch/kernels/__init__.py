"""Build, load and count the CUDA kernels in spiral_tpu_torch/csrc.

The sources compile with nvcc, one process per source, all started
together, into objects linked into one shared library with a plain C
interface, loaded with ctypes.  The build runs at first use, into
spiral_tpu_torch/_build/, and again whenever a source changes (the library
name carries a hash of the sources and flags).  Nothing here runs at
import, so the package imports on machines without CUDA.

Every C entry point launches on the stream it is given and returns
cudaGetLastError(); ``check`` raises on a nonzero code.  ``LAUNCHES``
counts kernel launches per kernel: each wrapper adds one where it
launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("ntt.cu", "firstdim.cu", "fold.cu", "expand.cu", "pack.cu",
           "fold_mxu.cu", "convert.cu", "threefry.cu")
HEADERS = ("common.cuh", "hopper.cuh", "ntt_reg.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# ring degrees the kernels on the register NTT (csrc/ntt_reg.cuh: K1,
# K3-K7, K4, K8a, K8b-1 and K9) are built for, one instance each: the presets'
# 256 and 2048; their wrappers raise on any other
REG_NTT_DEGREES = (256, 2048)

LAUNCHES = {"ntt": 0, "firstdim": 0, "fold": 0, "expand": 0,
            "fold_pack": 0, "pack": 0, "fold_batch": 0, "fold_pack_batch": 0,
            "auto": 0, "fold_ntt": 0, "fold_contract": 0, "compose": 0,
            "convert": 0, "threefry": 0}

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    "spiral_ntt": (_P, _P, _P, _I, _I, _I, _P),
    "spiral_firstdim": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "spiral_firstdim_pass_queries": (_I, _I),
    "spiral_fold_round": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "spiral_fold_pack_round": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "spiral_fold_round_batch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P),
    "spiral_fold_pack_round_batch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "spiral_pack": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "spiral_expand_keyswitch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "spiral_inv_ntt_automorph": (_P, _P, _P, _I, _I, _I, _P),
    "spiral_fold_ntt": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "spiral_fold_contract_smem": (_I, _I),
    "spiral_fold_contract": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "spiral_compose": (_P, _I, _P, _P, _P, _I, _P),
    "spiral_convert": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P),
    "spiral_uniform_residues": (_P, _I, ctypes.c_longlong, _I, _U, _U, _U,
                                _U, _P, _P),
}

_lib = None
build_log = ""
build_seconds = 0.0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; append their output to ``build_log`` and
    raise if any failed."""
    global build_log
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        build_log += out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into _build/libspiral_<hash>.so unless that
    library exists: one nvcc per source in parallel, then one link.
    verbose adds -Xptxas -v (which leaves the binary as it is) and keeps
    its report in ``build_log``."""
    global build_log, build_seconds
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libspiral_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    build_log = ""
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *flags, "-c", "-o", str(o), str(CSRC / s)]
                  for s, o in zip(SOURCES, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, so)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return so


def lib(verbose: bool = False):
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so = build(verbose)
        handle = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain path); raises on
    a mix of devices.  A CUDA tensor always goes to the kernel."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devs}")
    return False


def require(t: torch.Tensor, shape: tuple, name: str) -> None:
    """Check a kernel operand: CUDA, int32, contiguous, the given shape."""
    if t.device.type != "cuda" or t.dtype != torch.int32 or \
            not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want a contiguous int32 CUDA tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
