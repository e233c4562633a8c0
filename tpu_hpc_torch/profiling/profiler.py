"""Profiling: ``torch.profiler`` traces over a window of training steps.

Port of the JAX package's ``profiling/profiler.py``. Capability parity
with the reference's ``utils/profiling.py``: the ``training_profiler``
context manager with wait/warmup/active windowing (:25-66 -- here
``start_step``/``num_steps``, the schedule(wait, warmup, active) idea
collapsed to one window), rank-0-only trace output (:44-49), and a
memory summary (:69-86).

The window is keyed to the OWNER's step numbers (the Trainer's, or a
load harness's ticks), not to ``prof.step()`` calls, so the profile is
started and stopped explicitly (``torch.profiler.profile(...).start()``
/ ``.stop()``) instead of through ``torch.profiler.schedule``: a
chunked loop that reports only chunk boundaries still opens the window
at the first boundary past ``start_step``.

Activities: the CPU always; CUDA only when the profiled device is a
GPU (``device``, default: the current CUDA device when one is
available). So a CPU run writes a CPU-only trace.

Trace layout. ``jax.profiler`` writes a TensorBoard tree
(``<log_dir>/plugins/profile/<run>/...``); this module writes ONE
Chrome trace-event file per window,
``<log_dir>/rank<R>.step<N>.pt.trace.json`` (R the process's rank, N
the step the window opened at), which chrome://tracing, Perfetto and
TensorBoard's PyTorch profiler plugin load. Kernel launches appear as
``"cat": "kernel"`` events named after the kernel.

One profiler per process: ``torch.profiler`` keeps one Kineto session,
and a second ``start()`` silently takes it over from the first. So a
window that would open while any torch profiler is running raises
``RuntimeError`` (:func:`profiler_busy`) and leaves the running one
alone.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

from tpu_hpc_torch.logging_ import get_logger
from tpu_hpc_torch.logging_.logging import process_rank


# torch.profiler on the card (torch 2.11) drops the device events of the
# first kernels launched after a window opens -- their launch records
# stay in the trace -- 0 to 11 of them in one process, more in an older
# one (docs/port/profiler_repeat.py; the count is of kernels, not of
# time: the first launch came 3-11 ms after the start); late in
# chip_smoke.py's process the bench-Llama window lost its first flash
# forward that way. So a CUDA window opens with this many one-element
# fills and waits for them: the kernels the profiler drops are these,
# never the owner's.
SENTINEL_KERNELS = 256


def profiler_busy() -> bool:
    """True while a torch profiler (autograd or Kineto) runs in this
    process."""
    enabled = getattr(torch._C._autograd, "_profiler_enabled", None)
    if enabled is not None:
        return bool(enabled())
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


def _default_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class TrainingProfiler:
    """Step-windowed trace: profile steps [start_step, start_step +
    num_steps) on rank 0, skipping warmup/compilation steps (the
    reference's schedule(wait=1, warmup=1, active=3) -- :36-43)."""

    def __init__(
        self,
        log_dir: str = "profiles",
        start_step: int = 3,
        num_steps: int = 5,
        host0_only: bool = True,
        device=None,
    ):
        self.log_dir = log_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self.enabled = not host0_only or process_rank() == 0
        self.device = (torch.device(device) if device is not None
                       else _default_device())
        self.active = False
        self.trace_path: Optional[str] = None
        self._prof = None
        self._opened_at: Optional[int] = None
        self.logger = get_logger()

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def step(self, step: int) -> None:
        """Call with the owner's step number. Threshold (not equality)
        triggered, so chunked loops that advance many steps per host
        iteration still hit the window."""
        if not self.enabled:
            return
        # Open on threshold, not window membership: chunked loops call
        # this only at chunk boundaries, which may skip past the window
        # entirely (e.g. start_step=3 with 20-step epochs -> calls at
        # 0, 20, 40...).
        if not self.active and step >= self.start_step:
            self._start(step)
            self.logger.info(
                "profiler: tracing steps %d..%d -> %s",
                step, step + self.num_steps - 1, self.log_dir,
            )
        elif self.active and step >= self.start_step + self.num_steps:
            self.stop()

    def _start(self, step: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        if profiler_busy():
            raise RuntimeError(
                "profiler busy: a torch profiler is already running in "
                "this process (one Kineto session per process)"
            )
        activities = [ProfilerActivity.CPU]
        if self._cuda:
            activities.append(ProfilerActivity.CUDA)
            # Work queued before the window must not land in it.
            torch.cuda.synchronize(self.device)
        prof = profile(activities=activities)
        prof.start()
        if self._cuda:
            _absorb_first_kernels(self.device)
        self._prof = prof
        self._opened_at = int(step)
        self.active = True

    def annotate(self, step: int):
        """Step boundary range (the ``StepTraceAnnotation`` stand-in):
        ``with prof.annotate(step): train_step(...)`` puts a ``train``
        range around the step in the trace (the step number rides as
        the range's argument string)."""
        if self.active:
            return torch.profiler.record_function("train", str(step))
        return contextlib.nullcontext()

    def stop(self) -> None:
        """Close an open trace and write it. ``active`` is cleared even
        when the stop or the export raises (a full disk mid-write): a
        stop that failed must not make every later stop re-raise on an
        already-dead trace, which is what leaked the open trace the
        finally-guarantee exists for."""
        if not self.active:
            return
        prof = self._prof
        try:
            if self._cuda:
                # The window's kernels finish inside it.
                torch.cuda.synchronize(self.device)
            prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(
                self.log_dir,
                f"rank{process_rank()}.step{self._opened_at}.pt.trace.json",
            )
            prof.export_chrome_trace(path)
            self.trace_path = path
        finally:
            self.active = False
            self._prof = None
        self.logger.info(
            "profiler: trace written to %s (open with Perfetto or "
            "chrome://tracing)", self.trace_path,
        )

    # Context-manager form: ``with TrainingProfiler(...) as prof``
    # guarantees the trace is closed when the loop exhausts inside the
    # window or an exception unwinds through it -- an open profile
    # otherwise leaks for the life of the process (and blocks any later
    # window from starting).
    def __enter__(self) -> "TrainingProfiler":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def _absorb_first_kernels(device) -> None:
    """SENTINEL_KERNELS one-element fills on ``device``, then a wait for
    them: the first kernels of a window, which the profiler may drop."""
    one = torch.empty(1, device=device)
    for _ in range(SENTINEL_KERNELS):
        one.fill_(0.0)
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def training_profiler(
    log_dir: str = "profiles",
    start_step: int = 3,
    num_steps: int = 5,
    host0_only: bool = True,
    device=None,
) -> Iterator[TrainingProfiler]:
    """Context-manager form (parity: utils/profiling.py:25-66); always
    stops the trace on exit, even on error."""
    prof = TrainingProfiler(log_dir, start_step, num_steps, host0_only,
                            device)
    try:
        yield prof
    finally:
        prof.stop()


def _memory_stats(d) -> Optional[dict]:
    """The allocator's numbers for one device, in the JAX
    ``Device.memory_stats()`` keys: a CUDA device's from the caching
    allocator (``memory_allocated`` in use, ``max_memory_allocated``
    peak, the card's ``total_memory`` limit); None for a CPU device;
    an injected object's own ``memory_stats()``."""
    if isinstance(d, torch.device):
        if d.type != "cuda":
            return None
        return {
            "bytes_in_use": torch.cuda.memory_allocated(d),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(d),
            "bytes_limit": torch.cuda.get_device_properties(d).total_memory,
        }
    return d.memory_stats()


def device_memory_summary(
    logger=None,
    devices=None,
    emit: bool = True,
    sink: Optional[str] = None,
) -> Optional[dict]:
    """Per-device memory usage (the reference's profiler summary table
    analogue, :69-86; here sourced from the CUDA caching allocator
    rather than a trace).

    Beyond the log lines, the summary lands as telemetry (``emit=True``
    and any device reporting stats): one schema-stamped
    ``device_memory`` event (per-device in_use/peak/limit plus the
    maxima over devices) and an ``hbm_peak_bytes`` registry gauge -- so
    the obs report's memory section and the regress gate see memory
    high-water marks instead of them scrolling past in a log.
    ``devices`` defaults to every visible CUDA device (none on a
    CPU-only machine: then it returns None and emits nothing, as the
    JAX function does on the CPU) and is injectable for tests."""
    logger = logger or get_logger()
    if devices is None:
        devices = (
            [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if torch.cuda.is_available() else []
        )
    stats = {}
    for d in devices:
        s = _memory_stats(d)
        if not s:
            continue
        in_use = s.get("bytes_in_use", 0)
        limit = s.get("bytes_limit", 0)
        peak = s.get("peak_bytes_in_use", 0)
        stats[str(d)] = {"in_use": in_use, "limit": limit, "peak": peak}
        logger.info(
            "%s | in use %.2f GiB | peak %.2f GiB | limit %.2f GiB",
            d, in_use / 2**30, peak / 2**30, limit / 2**30,
        )
    if not stats:
        return None
    if emit:
        from tpu_hpc_torch.obs import get_bus, get_registry

        peak = max(s["peak"] for s in stats.values())
        get_bus().emit(
            "device_memory",
            sink=sink,
            n_devices=len(stats),
            hbm_peak_bytes=int(peak),
            hbm_in_use_bytes=int(
                max(s["in_use"] for s in stats.values())
            ),
            hbm_limit_bytes=int(
                max(s["limit"] for s in stats.values())
            ),
            per_device=stats,
        )
        get_registry().set_gauge(
            "hbm_peak_bytes", float(peak),
            help="Largest per-device HBM high-water mark (bytes) "
            "reported by the live allocator",
        )
    return stats
