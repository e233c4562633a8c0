"""Build-on-first-use loader for the port's CUDA kernels.

``tpu_hpc_torch/csrc/paged_attention.cu`` has a plain C interface, so
it is compiled with ``nvcc`` straight into a shared library and loaded
with ``ctypes`` -- no PyTorch headers, so a build takes seconds, not
minutes. The library lands in ``build/tpu_hpc_torch/`` at the root of
the checkout (listed in ``.gitignore``) the first time a kernel
launches, and is rebuilt whenever the source is newer than it.

Unlike the JAX package's native loader (``native/dataloader.py``),
a failed build raises: a CUDA tensor must reach its kernel or fail
loudly, never quietly take the plain PyTorch path.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "paged_attention.cu"
BUILD_DIR = _PKG.parent / "build" / "tpu_hpc_torch"
LIBRARY = BUILD_DIR / "libpaged_attention.so"
# nvcc's -Xptxas -v report (registers, shared memory, spills per
# kernel), kept beside the library for chip_smoke.py to print.
PTXAS_LOG = BUILD_DIR / "paged_attention.ptxas.txt"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the paged-attention kernels are built "
        "from tpu_hpc_torch/csrc at first launch"
    )


def _stale() -> bool:
    return (
        not LIBRARY.exists()
        or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime
    )


def build() -> float:
    """Compile the library if it is missing or older than its source;
    returns the seconds spent compiling. The output is written under a
    temporary name and renamed, so a concurrent loader never maps a
    half-written file. Raises ``RuntimeError`` with nvcc's output on
    failure."""
    if not _stale():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    PTXAS_LOG.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, LIBRARY)
    return took


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpuhpc_paged_decode.argtypes = (
        [p] * 9 + [i] * 7 + [f, i, i, p]
    )
    lib.tpuhpc_paged_decode.restype = i
    lib.tpuhpc_paged_prefill.argtypes = (
        [p] * 7 + [i] * 7 + [f, i, i, p]
    )
    lib.tpuhpc_paged_prefill.restype = i
    lib.tpuhpc_prefill_tile_rows.argtypes = [i] * 5
    lib.tpuhpc_prefill_tile_rows.restype = i
    lib.tpuhpc_error_string.argtypes = [i]
    lib.tpuhpc_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it first when needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIBRARY))
            _declare(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.tpuhpc_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
