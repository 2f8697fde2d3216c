"""Builds the CUDA kernels of ``rware_tpu_torch/csrc`` and loads them.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface for Hopper (``sm_90a``); ``ctypes`` loads it.  The library lands in
``build/rware_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
reused.  Nothing here runs at import: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rware_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_DIMS = [_I] * 9 + [ctypes.c_ulonglong]  # n s r g h w reward max_steps max_inactive, seed
_SIGNATURES = {
    # ... scripted T B | layout state_in state_out actions rewards episodes stream
    "rw_fused_rollout": _DIMS + [_I] * 3 + [_P] * 7,
    # ... deterministic T B sensor_range normalised L H1 H2 A threads smem_bytes |
    # layout state_in state_out w0 b0 w1 b1 wp bp wv bv obs action logp value
    # reward done stream
    "rw_fused_collect": _DIMS + [_I] * 11 + [_P] * 18,
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library.

    The returned handle carries ``build_log`` (the compiler's report,
    including ``ptxas`` register and spill counts) and ``build_seconds``
    (0 when an existing build was reused)."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cuh + cu:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"librware_kernels-{tag}.so"
    log_path = BUILD_DIR / f"nvcc-{tag}.log"
    seconds = 0.0
    if not lib_path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log_path.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rw_error_string.argtypes = [ctypes.c_int]
    lib.rw_error_string.restype = ctypes.c_char_p
    lib.build_log = log_path.read_text() if log_path.exists() else ""
    lib.build_seconds = seconds
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.rw_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
