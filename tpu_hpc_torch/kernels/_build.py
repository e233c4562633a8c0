"""Build-on-first-use loader for the port's CUDA kernels.

Every source in ``tpu_hpc_torch/csrc/*.cu`` has a plain C interface,
so each is compiled with ``nvcc`` (no PyTorch headers: a build takes
seconds, not minutes) and all of them are linked into ONE shared
library, loaded with ``ctypes``. The sources compile in parallel, one
``nvcc -c`` each, all started together; one more ``nvcc`` links the
objects. The library lands in ``build/tpu_hpc_torch/`` at the root of
the checkout (listed in ``.gitignore``) the first time a kernel
launches, and is rebuilt whenever any source or header it includes
(``csrc/*.cuh``) is newer than it.

Unlike the JAX package's native loader (``native/dataloader.py``),
a failed build raises: a CUDA tensor must reach its kernel or fail
loudly, never quietly take the plain PyTorch path.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_hpc_torch"
LIBRARY = BUILD_DIR / "libtpuhpc_kernels.so"
# nvcc's -Xptxas -v report (registers, shared memory, spills per
# kernel) of every source, kept beside the library for chip_smoke.py.
PTXAS_LOG = BUILD_DIR / "kernels.ptxas.txt"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Variants of one source built with -D overrides of its tile constants
# (kernels/autotune.py), each in its own directory.
VARIANT_DIR = BUILD_DIR / "autotune"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# A variant library the wrappers launch from while use_library is open.
_active: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    """The CUDA sources linked into the library, in a fixed order."""
    return sorted(SOURCE_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the kernels are built from "
        "tpu_hpc_torch/csrc at first launch"
    )


def _stale() -> bool:
    """Whether the library is missing or older than a source or a shared
    header (headers are not compiled on their own, but every source may
    include them)."""
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    inputs = [*sources(), *SOURCE_DIR.glob("*.cuh")]
    return any(src.stat().st_mtime > built for src in inputs)


def _fail(cmd, proc) -> RuntimeError:
    return RuntimeError(
        f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
        f"{proc.stdout}{proc.stderr}"
    )


def build() -> float:
    """Compile the library if it is missing or older than a source;
    returns the seconds spent. The objects and the library are written
    under temporary names and the library renamed into place, so a
    concurrent loader never maps a half-written file. Raises
    ``RuntimeError`` with nvcc's output on failure."""
    if not _stale():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", obj, str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
            jobs.append((cmd, proc, obj))
        logs, failed = [], None
        for cmd, proc, _ in jobs:
            out, err = proc.communicate()
            logs.append(out + err)
            if proc.returncode != 0 and failed is None:
                failed = _fail(cmd, subprocess.CompletedProcess(
                    cmd, proc.returncode, out, err))
        if failed is not None:
            raise failed
        lib_tmp = os.path.join(tmp, LIBRARY.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp,
               *(obj for _, _, obj in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise _fail(cmd, proc)
        PTXAS_LOG.write_text("".join(logs))
        os.replace(lib_tmp, LIBRARY)
    return time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _declare_flash(lib)
    # 11 pointers, (slots, hkv, g, d, bs, table_width, max_blocks,
    # n_split), scale, q and pool dtype codes, stream.
    lib.tpuhpc_paged_decode.argtypes = (
        [p] * 11 + [i] * 8 + [f, i, i, p]
    )
    lib.tpuhpc_paged_decode.restype = i
    lib.tpuhpc_decode_splits.argtypes = [i] * 4  # (slots, hkv, g, max_blocks)
    lib.tpuhpc_decode_splits.restype = i
    lib.tpuhpc_paged_prefill.argtypes = (
        [p] * 7 + [i] * 7 + [f, i, i, p]
    )
    lib.tpuhpc_paged_prefill.restype = i
    # (hkv, bucket, g, d, bs, q dtype code, pool dtype code)
    lib.tpuhpc_prefill_tile_rows.argtypes = [i] * 7
    lib.tpuhpc_prefill_tile_rows.restype = i
    lib.tpuhpc_prefill_route.argtypes = [i] * 4  # (d, bs, q code, pool code)
    lib.tpuhpc_prefill_route.restype = i
    lib.tpuhpc_error_string.argtypes = [i]
    lib.tpuhpc_error_string.restype = ctypes.c_char_p


def _declare_flash(lib: ctypes.CDLL) -> None:
    """The entry points of csrc/flash_attention.cu."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # flash_attention.cu: pointers, then (b, sq, sk, hq, hkv, d,
    # q_offset, kv_offset, causal[, accumulate]), scale, dtype code,
    # stream.
    lib.tpuhpc_flash_fwd.argtypes = [p] * 5 + [i] * 9 + [f, i, p]
    lib.tpuhpc_flash_fwd.restype = i
    lib.tpuhpc_flash_dq.argtypes = [p] * 7 + [i] * 10 + [f, i, p]
    lib.tpuhpc_flash_dq.restype = i
    lib.tpuhpc_flash_dkv.argtypes = [p] * 8 + [i] * 10 + [f, i, p]
    lib.tpuhpc_flash_dkv.restype = i
    lib.tpuhpc_flash_tile_rows.argtypes = [i, i]  # (kernel, dtype code)
    lib.tpuhpc_flash_tile_rows.restype = i


def _default_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIBRARY))
            _declare(lib)
            _lib = lib
        return _lib


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it first when needed; inside
    :func:`use_library`, the variant it was given."""
    if _active is not None:
        return _active
    return _default_library()


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (the message from
    the default library when ``lib`` is a variant without it)."""
    if code != 0:
        src = lib if hasattr(lib, "tpuhpc_error_string") \
            else _default_library()
        msg = src.tpuhpc_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def build_variants(variants: Dict[str, Dict[str, int]],
                   source: str = "flash_attention.cu") -> Dict[str, object]:
    """Compile ``source`` once per variant, each with its ``-D NAME=value``
    overrides, into ``VARIANT_DIR/<name>/lib.so`` -- all nvcc processes
    started together. Returns, per variant, the library's path or, when
    nvcc refused it, ``RuntimeError`` with nvcc's output (a constant the
    source's static_asserts reject fails here, at compile time)."""
    nvcc = _nvcc()
    src = SOURCE_DIR / source
    newest = max(p.stat().st_mtime
                 for p in (src, *SOURCE_DIR.glob("*.cuh")))
    jobs, built = {}, {}
    for name, defines in variants.items():
        out_dir = VARIANT_DIR / name
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / "lib.so"
        if lib.exists() and lib.stat().st_mtime > newest:
            built[name] = lib  # built before from the same sources
            continue
        cmd = [nvcc, *COMPILE_FLAGS,
               *(f"-D{k}={v}" for k, v in sorted(defines.items())),
               "-shared", "-o", str(lib), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (cmd, proc, lib)
    for name, (cmd, proc, lib) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            built[name] = _fail(cmd, subprocess.CompletedProcess(
                cmd, proc.returncode, out, err))
        else:
            built[name] = lib
    return built


def load_variant(path) -> ctypes.CDLL:
    """A variant library of flash_attention.cu (:func:`build_variants`)
    with its entry points declared."""
    lib = ctypes.CDLL(str(path))
    _declare_flash(lib)
    return lib


@contextlib.contextmanager
def use_library(lib: ctypes.CDLL):
    """Launch the wrappers' kernels from ``lib`` inside the block (the
    autotuner's candidates); the default library again after it."""
    global _active
    if _active is not None:
        raise RuntimeError("use_library blocks do not nest")
    _active = lib
    try:
        yield lib
    finally:
        _active = None
