"""Build and load the port's CUDA kernel library.

All kernels live in ``bayesian_bm25_tpu_torch/csrc/*.cu`` behind a plain
C interface. At first use they are compiled for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and linked into one shared
library under
``bayesian_bm25_tpu_torch/_build/`` and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edit
to any ``.cu`` file triggers a rebuild and a stale library is never
loaded. Nothing here runs at import time: this module imports on a
machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported launcher: argtypes, all returning the
# cudaError_t of the launch as an int.
_SIGNATURES = {
    "bb25_block_max": [_VP, _VP, _I, _I, _I, _I, _VP],
    "bb25_row_gather": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "bb25_topk": [_VP, _VP, _VP, _I, _I, _I, _VP],
    "bb25_bm25_compare": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                          _VP],
    "bb25_impact_matmul_bmax": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                                _I, _I, _I, _I, _VP],
}
# Exported helpers that return a size: argtypes, returning long long.
_SIZES = {"bb25_impact_matmul_scratch_bytes": [_I, _I, _I]}

_lib = None
build_seconds: float | None = None
# ptxas's resource report (registers, shared memory, spills) per source
# from the last build.
build_log: dict[str, str] = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "bayesian_bm25_tpu_torch are built from source at first use")


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbb25_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; return its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    global build_seconds
    import time

    path = library_path()
    if path.exists():
        return path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        # One nvcc per source, all started together, then one link.
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        compile_flags.append("-Xptxas=-v")
        jobs = []
        for src in _sources():
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *compile_flags, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        done = [(cmd, *proc.communicate(), proc.returncode)
                for cmd, _, proc in jobs]
        for cmd, out, err, code in done:
            if code != 0:
                _fail(cmd, code, out, err)
            build_log[Path(cmd[-1]).stem] = err
        tmp = os.path.join(work, path.name)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            _fail(cmd, proc.returncode, proc.stdout, proc.stderr)
        os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return path


def _fail(cmd, code, out, err):
    raise RuntimeError(
        f"nvcc failed (exit {code}): {' '.join(cmd)}\n{out}\n{err}")


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for table, restype in ((_SIGNATURES, ctypes.c_int),
                               (_SIZES, ctypes.c_longlong)):
            for name, argtypes in table.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
