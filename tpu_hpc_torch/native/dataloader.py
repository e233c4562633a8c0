"""ctypes binding for the C++ data pipeline (src/dataloader.cpp).

Port of the JAX package's ``native/dataloader.py``: the same C++
source (copied beside this file), the same ctypes binding, the same
file formats and the same batches, byte for byte, for the same file,
seed and step. What differs:

* the library is built with g++ at first use into
  ``build/tpu_hpc_torch/native/`` at the root of the checkout (listed in
  ``.gitignore``), never beside the source, and rebuilt when the source
  is newer than it;
* a failed build RAISES (``RuntimeError`` with g++'s output): there is
  no ``native_available()`` that quietly says False;
* batches are torch CPU tensors. Each batch owns its memory: the ring
  copies into a buffer allocated for that batch alone, never into one
  it refills later, so a ``tensor.to(device, non_blocking=True)`` in
  flight (``Trainer._to_device``) can never see its bytes change under
  it;
* ``prepare_on_host0`` synchronizes over ``torch.distributed`` (a
  barrier) instead of the JAX process sync.

Role parity with the reference's DataLoader(num_workers=4,
pin_memory=True) input path: background native threads keep batches
ahead of the training loop. Use ``models.datasets`` (seeded generators)
for synthetic benchmarks; use this loader where the host must produce
the data (real datasets, CPU-side preprocessing).
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "src" / "dataloader.cpp"
BUILD_DIR = _HERE.parent.parent / "build" / "tpu_hpc_torch" / "native"
LIBRARY = BUILD_DIR / "libtpu_hpc_data.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(source: Optional[Path] = None,
          library: Optional[Path] = None) -> None:
    """Compile ``source`` (default :data:`SOURCE`) into ``library``
    (default :data:`LIBRARY`) with g++, written under a temporary name
    and renamed into place, so a concurrent loader never maps a
    half-written file. Raises ``RuntimeError`` with g++'s output when
    the compiler is missing or refuses the source."""
    source = SOURCE if source is None else source
    library = LIBRARY if library is None else library
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
           "-fPIC", "-pthread", str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(
            f"native dataloader build failed: cannot run g++ ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native dataloader build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, library)


def _declare(lib: ctypes.CDLL) -> None:
    i64, u64, i32 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_int
    vp, fp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.era5_gen.argtypes = [i64, i64, i64, i64, u64, i64, fp, fp]
    lib.era5_prefetcher_create.restype = vp
    lib.era5_prefetcher_create.argtypes = [i64, i64, i64, i64, u64, i32, i32]
    lib.era5_prefetcher_next.restype = i32
    lib.era5_prefetcher_next.argtypes = [vp, fp, fp, i64p]
    lib.era5_prefetcher_seek.argtypes = [vp, i64]
    lib.era5_prefetcher_destroy.argtypes = [vp]
    lib.file_dataset_open.restype = vp
    lib.file_dataset_open.argtypes = [ctypes.c_char_p, i64, u64, i32, i32]
    lib.file_dataset_info.argtypes = [vp, i64p, i64p, i64p]
    lib.file_dataset_batch.argtypes = [vp, i64, fp, fp]
    lib.file_dataset_next.restype = i32
    lib.file_dataset_next.argtypes = [vp, fp, fp, i64p]
    lib.file_dataset_seek.argtypes = [vp, i64]
    lib.file_dataset_close.argtypes = [vp]
    lib.token_dataset_open.restype = vp
    lib.token_dataset_open.argtypes = [ctypes.c_char_p, i64, i64, u64, i32,
                                       i32]
    lib.token_dataset_info.argtypes = [vp, i64p, i64p, i64p]
    lib.token_dataset_batch.argtypes = [vp, i64, fp, fp]
    lib.token_dataset_next.restype = i32
    lib.token_dataset_next.argtypes = [vp, fp, fp, i64p]
    lib.token_dataset_seek.argtypes = [vp, i64]
    lib.token_dataset_close.argtypes = [vp]


def load_library() -> ctypes.CDLL:
    """The loaded C++ library, built first when it is missing or older
    than its source. Raises when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            if not LIBRARY.exists() or (
                LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime
            ):
                build()
            lib = ctypes.CDLL(str(LIBRARY))
            _declare(lib)
            _lib = lib
        return _lib


def _fptr(a: torch.Tensor):
    return ctypes.cast(a.data_ptr(), ctypes.POINTER(ctypes.c_float))


class _PrefetchedStream:
    """Shared ring-resync protocol over a native prefetcher (the JAX
    package's, unchanged):

    * sequential reads ride the C++ prefetch ring;
    * a one-off jump is served synchronously, ring untouched (a
      mid-training eval re-read must not discard the training stream's
      prefetched window);
    * a jump followed by a sequential read -- the checkpoint-resume
      pattern -- reseeks the ring there and prefetching resumes.

    Identical bytes on every path: batches are pure functions of
    (seed, step). Every read copies into tensors :meth:`_alloc` made for
    that batch alone (see the module docstring).
    """

    def _init_stream(self):
        self._next_seq = 0
        self._resync_at: Optional[int] = None

    def next(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Next sequential batch from the prefetch ring."""
        x, y = self._alloc()
        step = ctypes.c_int64()
        rc = self._ring_next(x, y, step)
        if rc != 0:
            # Shutdown raced the wait: outputs are uninitialized
            # memory, never hand them to the caller.
            raise RuntimeError("native prefetcher shut down mid-read")
        self._next_seq = step.value + 1
        return x, y

    def batch_at(self, step: int, batch_size: int):
        """Random-access batch (Trainer contract)."""
        if batch_size != self.batch_size:
            raise ValueError(
                f"batch {batch_size} != stream batch {self.batch_size}"
            )
        if step == self._next_seq:
            self._resync_at = None
            return self.next()
        if step == self._resync_at:
            # Second sequential read after a jump: this is a new
            # stream, not random access -- move the ring to it.
            self._ring_seek(step)
            self._next_seq = step
            self._resync_at = None
            return self.next()
        self._resync_at = step + 1
        x, y = self._alloc()
        self._sync_batch(step, x, y)
        return x, y

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


@dataclasses.dataclass
class NativeERA5Stream(_PrefetchedStream):
    """Host-side ERA5-like stream with native prefetching: NHWC float32
    ``[B, lat, lon, channels]`` pairs, deterministic in (seed, step)."""

    batch_size: int
    lat: int = 181
    lon: int = 360
    channels: int = 20
    seed: int = 0
    prefetch_depth: int = 4
    n_threads: int = 2

    def __post_init__(self):
        self._lib = load_library()
        self._handle = self._lib.era5_prefetcher_create(
            self.batch_size, self.lat, self.lon, self.channels,
            self.seed, self.prefetch_depth, self.n_threads,
        )
        self._init_stream()

    @property
    def sample_shape(self) -> Tuple[int, int, int]:
        return (self.lat, self.lon, self.channels)

    def _alloc(self):
        shape = (self.batch_size, self.lat, self.lon, self.channels)
        return (torch.empty(shape, dtype=torch.float32),
                torch.empty(shape, dtype=torch.float32))

    def _ring_next(self, x, y, step) -> int:
        return self._lib.era5_prefetcher_next(
            self._handle, _fptr(x), _fptr(y), ctypes.byref(step))

    def _ring_seek(self, step: int) -> None:
        self._lib.era5_prefetcher_seek(self._handle, step)

    def _sync_batch(self, step: int, x, y) -> None:
        self._lib.era5_gen(
            self.batch_size, self.lat, self.lon, self.channels,
            self.seed, step, _fptr(x), _fptr(y))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.era5_prefetcher_destroy(self._handle)
            self._handle = None


_FILE_MAGIC = 0x3144435048555054  # "TPUHPCD1" little-endian


def prepare_on_host0(prepare_fn, paths) -> None:
    """Rank 0 materializes ``paths`` via ``prepare_fn`` if any is
    missing; every rank then meets at a ``torch.distributed`` barrier
    before reading them -- the reference's rank-0-download +
    dist.barrier() pattern without the race. With no process group up
    this is rank 0 alone. Generic over what is being prepared (image
    records, token corpora, ...)."""
    import torch.distributed as dist

    from tpu_hpc_torch.resilience.retry import retry_call

    up = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if up else 0
    if rank == 0 and not all(os.path.exists(p) for p in paths):
        prepare_fn()
    if up and dist.get_world_size() > 1:
        dist.barrier()

    def check_visible():
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                f"prepare did not produce {missing} -- is the data "
                "directory shared across hosts (NFS or the like)? Each "
                "rank needs to see the same files."
            )

    # Shared filesystems are close-to-open consistent at best: a file
    # rank 0 just wrote can take seconds to appear on other hosts even
    # after the barrier. Bounded retry instead of failing the job on
    # the propagation race.
    retry_call(
        check_visible, retries=4, base_delay=0.5, max_delay=8.0,
        retry_on=(FileNotFoundError,),
        describe="shared-filesystem dataset visibility",
    )


def write_dataset(path: str, x: np.ndarray, y: np.ndarray) -> str:
    """Write (x, y) sample arrays as a binary record dataset: float32
    records, x then y per sample, after a 4 x uint64 header (magic, n,
    x elements, y elements). The JAX package's format, byte for byte."""
    x = np.ascontiguousarray(np.asarray(x), np.float32)
    y = np.ascontiguousarray(np.asarray(y), np.float32)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"sample counts differ: {x.shape[0]} vs {y.shape[0]}")
    n = x.shape[0]
    xe = int(np.prod(x.shape[1:], dtype=np.int64))
    ye = int(np.prod(y.shape[1:], dtype=np.int64))
    rec = np.empty((n, xe + ye), np.float32)
    rec[:, :xe] = x.reshape(n, xe)
    rec[:, xe:] = y.reshape(n, ye)
    with open(path, "wb") as f:
        np.asarray([_FILE_MAGIC, n, xe, ye], np.uint64).tofile(f)
        rec.tofile(f)
    return path


@dataclasses.dataclass
class NativeFileDataset(_PrefetchedStream):
    """Train from a record file via the mmap'd C++ reader. Epoch
    shuffling is a per-epoch Feistel permutation -- every epoch visits
    every sample exactly once in a different deterministic order.
    ``x_shape``/``y_shape`` restore the per-sample shapes the flat
    records lost."""

    path: str
    batch_size: int
    x_shape: Tuple[int, ...]
    y_shape: Tuple[int, ...]
    seed: int = 0
    prefetch_depth: int = 4
    n_threads: int = 2

    def __post_init__(self):
        lib = self._lib = load_library()
        self._handle = lib.file_dataset_open(
            self.path.encode(), self.batch_size, self.seed,
            self.prefetch_depth, self.n_threads,
        )
        if not self._handle:
            raise ValueError(f"not a tpu_hpc dataset file: {self.path}")
        n, xe, ye = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        lib.file_dataset_info(
            self._handle, ctypes.byref(n), ctypes.byref(xe), ctypes.byref(ye))
        self.n_samples = n.value
        if xe.value != int(np.prod(self.x_shape, dtype=np.int64)):
            raise ValueError(
                f"x_shape {self.x_shape} != {xe.value} elems in file")
        if ye.value != int(np.prod(self.y_shape, dtype=np.int64)):
            raise ValueError(
                f"y_shape {self.y_shape} != {ye.value} elems in file")
        self._init_stream()

    def _alloc(self):
        return (
            torch.empty((self.batch_size, *self.x_shape), dtype=torch.float32),
            torch.empty((self.batch_size, *self.y_shape), dtype=torch.float32),
        )

    def _ring_next(self, x, y, step) -> int:
        return self._lib.file_dataset_next(
            self._handle, _fptr(x), _fptr(y), ctypes.byref(step))

    def _ring_seek(self, step: int) -> None:
        self._lib.file_dataset_seek(self._handle, step)

    def _sync_batch(self, step: int, x, y) -> None:
        self._lib.file_dataset_batch(self._handle, step, _fptr(x), _fptr(y))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.file_dataset_close(self._handle)
            self._handle = None


_TOKEN_MAGIC = 0x3154435048555054  # "TPUHPCT1" little-endian


def write_token_dataset(path: str, tokens: np.ndarray) -> str:
    """Write a flat token-id corpus: uint16 when every id fits, else
    uint32, after a 4 x uint64 header (magic, n_tokens, itemsize,
    max id). The JAX package's format, byte for byte."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be 1D, got shape {tokens.shape}")
    if tokens.size < 2:
        raise ValueError("corpus needs at least 2 tokens")
    if not np.issubdtype(tokens.dtype, np.integer):
        raise ValueError(f"tokens must be integers, got {tokens.dtype}")
    lo, hi = int(tokens.min()), int(tokens.max())
    if lo < 0 or hi > 0xFFFFFFFF:
        raise ValueError("token ids must fit in uint32")
    dtype = np.uint16 if hi <= 0xFFFF else np.uint32
    data = np.ascontiguousarray(tokens, dtype)
    with open(path, "wb") as f:
        # Header word 3 carries the max id so loaders can validate the
        # corpus against a model's vocab_size at open time.
        np.asarray(
            [_TOKEN_MAGIC, data.size, data.dtype.itemsize, hi], np.uint64,
        ).tofile(f)
        data.tofile(f)
    return path


@dataclasses.dataclass
class NativeTokenDataset(_PrefetchedStream):
    """Next-token training batches from a mmap'd token corpus.

    Window w covers tokens [w*seq_len, w*seq_len + seq_len]; a batch is
    (inputs, targets) int32 ``[B, S]`` CPU tensors with targets shifted
    one token. Per-epoch Feistel shuffle (every window exactly once per
    epoch, deterministic in (seed, step)). Drop-in for
    ``datasets.TokenStream`` where the tokens come from disk.
    ``max_token_id`` is the header's, for a check against the model's
    vocabulary."""

    path: str
    batch_size: int
    seq_len: int
    seed: int = 0
    prefetch_depth: int = 4
    n_threads: int = 2

    def __post_init__(self):
        if self.seq_len <= 0 or self.batch_size <= 0:
            raise ValueError(
                f"seq_len {self.seq_len} and batch_size "
                f"{self.batch_size} must be positive"
            )
        lib = self._lib = load_library()
        self._handle = lib.token_dataset_open(
            self.path.encode(), self.batch_size, self.seq_len,
            self.seed, self.prefetch_depth, self.n_threads,
        )
        if not self._handle:
            # The C++ opener only reports "no": tell the three causes
            # apart so a valid-but-short corpus is not called corrupt.
            if not os.path.exists(self.path):
                raise FileNotFoundError(self.path)
            try:
                hdr = np.fromfile(self.path, np.uint64, count=2)
            except OSError:
                hdr = np.zeros(0, np.uint64)
            if (len(hdr) == 2 and hdr[0] == _TOKEN_MAGIC
                    and int(hdr[1]) <= self.seq_len):
                raise ValueError(
                    f"corpus too short: {int(hdr[1])} tokens cannot "
                    f"fill one seq_len={self.seq_len} window "
                    "(needs seq_len + 1)"
                )
            raise ValueError(
                f"not a tpu_hpc token dataset (corrupt header?): {self.path}"
            )
        nt, nw, mx = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        lib.token_dataset_info(
            self._handle, ctypes.byref(nt), ctypes.byref(nw),
            ctypes.byref(mx))
        self.n_tokens = nt.value
        self.n_windows = nw.value
        self.max_token_id = mx.value
        self._init_stream()

    def _alloc(self):
        # int32 buffers ride the ring's float* interface as raw bit
        # patterns (the C++ side reinterprets; the ring moves bytes).
        shape = (self.batch_size, self.seq_len)
        return (torch.empty(shape, dtype=torch.int32),
                torch.empty(shape, dtype=torch.int32))

    def _ring_next(self, x, y, step) -> int:
        return self._lib.token_dataset_next(
            self._handle, _fptr(x), _fptr(y), ctypes.byref(step))

    def _ring_seek(self, step: int) -> None:
        self._lib.token_dataset_seek(self._handle, step)

    def _sync_batch(self, step: int, x, y) -> None:
        self._lib.token_dataset_batch(self._handle, step, _fptr(x), _fptr(y))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.token_dataset_close(self._handle)
            self._handle = None
