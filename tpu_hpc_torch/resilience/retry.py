"""Bounded retry with exponential backoff and deterministic jitter.

The generic lever under every transient-failure site in the framework:
``torch.distributed.init_process_group`` racing slow coordinator startup,
checkpoint restore hitting a flaky shared filesystem, dataset files
not yet visible to a host after rank-0 prepared them (close-to-open
consistency on NFS/GCS). One policy, one place, instead of ad-hoc
sleep loops per call site.

Jitter is DETERMINISTIC given a seed (``random.Random(seed)``, never
the global RNG): restart behavior must be reproducible under the fault
injector, and the bounds are testable -- delay k lies in
``[d_k, d_k * (1 + jitter)]`` with ``d_k = min(base * 2^k, max_delay)``.
Jitter still does its fleet-level job (de-synchronizing N hosts
retrying the same coordinator) because each host seeds with its own
process id by default.
"""
from __future__ import annotations

import os
import random
import time
from typing import Any, Callable, Iterator, Optional, Tuple, Type


def backoff_delays(
    retries: int,
    base_delay: float = 0.5,
    max_delay: float = 30.0,
    jitter: float = 0.5,
    seed: Optional[int] = None,
) -> Iterator[float]:
    """Yield ``retries`` delays: exponential, capped, jittered.

    Delay k is ``d_k * (1 + jitter * u_k)`` with
    ``d_k = min(base_delay * 2^k, max_delay)`` and ``u_k`` uniform in
    [0, 1) from ``random.Random(seed)`` -- so every delay lies in
    ``[d_k, d_k * (1 + jitter)]``. Default seed: this process's pid,
    de-synchronizing hosts that fail in lockstep.
    """
    if retries < 0:
        raise ValueError(f"retries {retries} must be >= 0")
    if base_delay < 0 or max_delay < 0 or jitter < 0:
        raise ValueError(
            f"negative backoff parameter (base {base_delay}, "
            f"max {max_delay}, jitter {jitter})"
        )
    rng = random.Random(os.getpid() if seed is None else seed)
    for k in range(retries):
        d = min(base_delay * (2.0 ** k), max_delay)
        yield d * (1.0 + jitter * rng.random())


def retry_call(
    fn: Callable[..., Any],
    args: Tuple = (),
    kwargs: Optional[dict] = None,
    *,
    retries: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 30.0,
    jitter: float = 0.5,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    seed: Optional[int] = None,
    describe: str = "",
) -> Any:
    """Call ``fn(*args, **kwargs)``; on a ``retry_on`` exception, back
    off and try again, up to ``retries`` extra attempts.

    ``on_retry(attempt, exc, delay)`` fires before each backoff sleep
    (logging hook). The final failure re-raises the last exception
    unchanged -- a retry wrapper must never replace the real
    traceback. ``sleep``/``seed`` are injectable for tests.
    """
    kwargs = kwargs or {}
    delays = backoff_delays(
        retries, base_delay, max_delay, jitter, seed=seed
    )
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            attempt += 1
            try:
                delay = next(delays)
            except StopIteration:
                raise exc from None
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            else:
                name = describe or getattr(fn, "__name__", repr(fn))
                print(
                    f"tpu_hpc retry: {name} failed "
                    f"(attempt {attempt}/{retries + 1}: "
                    f"{type(exc).__name__}: {exc}); retrying in "
                    f"{delay:.2f}s",
                    flush=True,
                )
            sleep(delay)


def retrying(**policy) -> Callable[[Callable], Callable]:
    """Decorator form of :func:`retry_call` with a bound policy."""

    def deco(fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            return retry_call(fn, args, kwargs, **policy)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped

    return deco
