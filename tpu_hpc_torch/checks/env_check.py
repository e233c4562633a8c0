"""Pre-flight environment verification.

Port of the JAX package's ``checks/env_check.py`` (itself the
reference's ``tests/check_environment.py`` and ``tests/test_env.py``):
library discovery, an env dump, a collective smoke test with an exact
expected value, per-card burn-in rates and a pass/fail summary. On the
card the checks are the reference's own: the torch, CUDA and NCCL
versions (``torch.cuda.nccl.version()``), ``nvcc --version`` (the
kernels are built from source at first launch) and whether triton
imports; the NCCL all-reduce smoke test; the bf16 matmul and HBM copy
rates beside the card table's (``checks/roofline.py``).

``python -m tpu_hpc_torch.checks.env_check`` checks the card (the
default); ``--device cpu`` runs the checks that need none (a gloo
world for the smoke test, no rates). Under ``torchrun`` every rank joins
the job's process group and the smoke test runs over all of them.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpu_hpc_torch.runtime.topology import topology_report

# Env vars that shape NCCL / CUDA / PyTorch behaviour -- the dump the
# reference prints (check_environment.py:263-301).
_ENV_VARS = (
    "CUDA_VISIBLE_DEVICES",
    "CUDA_DEVICE_MAX_CONNECTIONS",
    "CUDA_LAUNCH_BLOCKING",
    "CUDA_HOME",
    "PYTORCH_CUDA_ALLOC_CONF",
    "TORCH_NCCL_AVOID_RECORD_STREAMS",
    "TORCH_NCCL_ASYNC_ERROR_HANDLING",
    "NCCL_DEBUG",
    "NCCL_ALGO",
    "NCCL_PROTO",
    "NCCL_NVLS_ENABLE",
    "NCCL_IB_DISABLE",
    "NCCL_SOCKET_IFNAME",
    "NCCL_P2P_DISABLE",
    "MASTER_ADDR",
    "MASTER_PORT",
    "RANK",
    "WORLD_SIZE",
    "LOCAL_RANK",
)

# The pins file of the port's stack (the JAX package reads the repo's
# constraints.txt, which pins the JAX stack).
PINS_FILE = Path(__file__).resolve().parent.parent / "constraints.txt"


def _nvcc_version() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        return "not found"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not runnable ({e})"
    m = re.search(r"release [0-9.]+, V([0-9.]+)", out)
    return m.group(1) if m else (out.strip() or "unknown")


def _library_versions() -> Dict[str, str]:
    """Version discovery (parity: the reference's NCCL version and
    path, check_environment.py:31-73)."""
    out = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
    }
    try:
        import numpy

        out["numpy"] = numpy.__version__
    except ImportError:  # pragma: no cover
        out["numpy"] = "not importable"
    if torch.cuda.is_available():
        v = torch.cuda.nccl.version()
        out["nccl"] = ".".join(map(str, v)) if isinstance(v, tuple) else str(v)
    else:
        out["nccl"] = "no CUDA device (ok for --device cpu)"
    out["nvcc"] = _nvcc_version()
    try:
        import triton  # noqa: F401

        out["triton"] = getattr(triton, "__version__", "present")
    except Exception:
        out["triton"] = "not importable"
    return out


def _pinned_versions(path: Path = PINS_FILE) -> Dict[str, str]:
    """``name==version`` lines of the port's pins file (empty when the
    file is absent, as in an installed-package deployment)."""
    if not path.is_file():
        return {}
    pins = {}
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#") and "==" in line:
            name, _, ver = line.partition("==")
            pins[name.strip()] = ver.strip()
    return pins


def check_version_pins(path: Path = PINS_FILE) -> Tuple[bool, str]:
    """Warn-only drift check of installed packages against the pins.
    Always "passes" -- drift is a warning, since newer stacks are
    usually fine -- but the detail names every mismatch."""
    import importlib.metadata as md

    pins = _pinned_versions(path)
    if not pins:
        return True, f"no pins file at {path} (skipped)"
    drift = []
    for name, want in pins.items():
        try:
            have = md.version(name)
        except md.PackageNotFoundError:
            drift.append(f"{name}: pinned {want}, not installed")
            continue
        if have != want:
            drift.append(f"{name}: pinned {want}, installed {have}")
    if drift:
        return True, f"DRIFT from {path.name} (warn only): " + "; ".join(drift)
    return True, f"all {len(pins)} pins match {path.name}"


def _smoke_all_reduce(device: str = "cuda") -> Tuple[bool, str]:
    """All-reduce smoke test with an exact expected value: rank r
    contributes ``arange(4) + r`` and every rank must read back the
    exact sum over ranks (the reference's world-size-1 NCCL all-reduce,
    test_env.py:54-79, and its result == sum(range(world_size)) assert).

    Over the job's process group when one is up; otherwise over a
    one-rank world made for the test (NCCL on a card, gloo with
    ``device="cpu"``) at a free localhost port, torn down after."""
    import torch.distributed as dist

    from tpu_hpc_torch.runtime.sim import free_port

    own = not dist.is_initialized()
    try:
        if own:
            dist.init_process_group(
                "nccl" if device == "cuda" else "gloo",
                init_method=f"tcp://127.0.0.1:{free_port()}",
                world_size=1, rank=0)
        rank, world = dist.get_rank(), dist.get_world_size()
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device("cpu"))
        x = torch.arange(4, dtype=torch.float32, device=dev) + rank
        dist.all_reduce(x)
        got = x.cpu().tolist()
        expected = [float(i * world + sum(range(world))) for i in range(4)]
        backend = dist.get_backend()
        return got == expected, (
            f"{backend} all_reduce over {world} rank(s): got {got}, "
            f"expected {expected}")
    except Exception as e:  # the check reports, the caller decides
        return False, f"all-reduce smoke test raised: {e!r}"
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()


def _marginal(t_long: float, t_short: float, what: str) -> float:
    """The marginal seconds between two iteration counts. Timing noise
    that swamps them is an error, never a clamped (absurdly large) rate
    that would hide the throttled-card condition this check exists
    for."""
    dt = t_long - t_short
    if dt <= 1e-4:
        raise RuntimeError(
            f"{what} timing indeterminate (dt={dt * 1e3:.2f} ms); "
            "host too noisy for a marginal-rate measurement"
        )
    return dt


def time_loop(n: int, fn: Callable, x: torch.Tensor) -> float:
    """Seconds for ``n`` applications of ``fn`` chained on ``x`` (CUDA
    events on a card, the host clock on the CPU), after one warm
    application."""
    x = fn(x)
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(x.device)
        start.record()
        for _ in range(n):
            x = fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    import time

    t0 = time.perf_counter()
    for _ in range(n):
        x = fn(x)
    return time.perf_counter() - t0


def chip_microbench(dim: int = 4096, iters: int = 10,
                    device: Optional[str] = None,
                    copy_bytes: int = 1 << 30) -> Dict[str, float]:
    """Per-card burn-in numbers: dense bf16 matmul TFLOP/s
    (``torch.matmul``) and HBM copy GB/s (an in-place add over a
    ``copy_bytes`` fp32 tensor: one read and one write a pass), on this
    process's card (``device`` None) or the one named.

    The JAX package's marginal-cost rule: each rate is the cost between
    a short and a long chain of the same operation, so launch and
    timer overheads cancel; a difference that noise swamps raises (see
    :func:`_marginal`). A card delivering far below its data sheet
    (thermal throttle, a lowered power limit, sharing) shows up here
    before any training run does."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((dim, dim), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    # *1e-3 keeps the iterated product finite (cost unchanged).
    mmstep = lambda y: torch.matmul(y, y) * 1e-3  # noqa: E731
    dt = _marginal(time_loop(10 + iters * 10, mmstep, a),
                   time_loop(10, mmstep, a), "matmul")
    tflops = 2 * dim ** 3 * iters * 10 / dt / 1e12
    del a
    big = torch.zeros(copy_bytes // 4, dtype=torch.float32, device=dev)
    cpstep = lambda y: y.add_(1.0)  # noqa: E731
    dt = _marginal(time_loop(5 + iters * 5, cpstep, big),
                   time_loop(5, cpstep, big), "hbm copy")
    # read + write per pass.
    gbs = 2 * big.numel() * 4 * iters * 5 / dt / 1e9
    del big
    return {"matmul_tflops": tflops, "hbm_gb_s": gbs}


def check_environment(verbose: bool = True, device: str = "cuda") -> Dict:
    """Run all checks; return a report dict with a pass/fail summary
    (parity: check_environment.py:349-373). ``device="cuda"`` (the
    default) checks the card: no card is a failed check. ``"cpu"``
    skips what needs one."""
    import torch.distributed as dist

    from tpu_hpc_torch.checks.roofline import chip_for_kind

    report = {
        "versions": _library_versions(),
        "topology": topology_report(),
        "env": {k: os.environ.get(k) for k in _ENV_VARS
                if os.environ.get(k)},
    }
    checks: List[Tuple[str, bool, str]] = []
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device == "cuda":
        checks.append(("devices_visible", n_cards > 0,
                       f"{n_cards} CUDA device(s)"))
    ok, msg = check_version_pins()
    checks.append(("version_pins", ok, msg))
    if device == "cuda" and n_cards == 0:
        checks.append(("all_reduce_smoke", False, "no CUDA device"))
    else:
        ok, msg = _smoke_all_reduce(device)
        checks.append(("all_reduce_smoke", ok, msg))
    if device == "cuda" and n_cards > 0:
        name = torch.cuda.get_device_name()
        spec = chip_for_kind(name)
        checks.append(("card_in_table", spec is not None,
                       f"{name} -> {spec.name if spec else 'unknown'}"))
        try:
            rates = chip_microbench()
            report["microbench"] = rates
            ok = rates["matmul_tflops"] > 10
            detail = (f"{rates['matmul_tflops']:.0f} bf16 TFLOP/s, "
                      f"{rates['hbm_gb_s']:.0f} GB/s HBM copy")
            if spec is not None:
                # A reading above the data sheet is a broken clock, not
                # a fast card.
                frac = {"matmul": rates["matmul_tflops"] * 1e12
                        / spec.peak_bf16_flops,
                        "hbm": rates["hbm_gb_s"] / spec.hbm_gbps}
                report["microbench_of_spec"] = frac
                ok = ok and max(frac.values()) <= 1.05
                detail += (f" ({frac['matmul']:.1%} / {frac['hbm']:.1%} of "
                           f"the {spec.name} data sheet)")
            checks.append(("chip_microbench", ok, detail))
        except Exception as e:
            checks.append(("chip_microbench", False, f"raised: {e!r}"))

    report["checks"] = [
        {"name": n, "passed": p, "detail": d} for n, p, d in checks
    ]
    report["all_passed"] = all(p for _, p, _ in checks)

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if verbose and rank0:
        print("=" * 64)
        print("tpu_hpc_torch environment check")
        print("=" * 64)
        for k, v in report["versions"].items():
            print(f"  {k:>16}: {v}")
        topo = report["topology"]
        print(f"  {'backend':>16}: {topo['backend']}")
        print(f"  {'devices':>16}: {topo['local_device_count']} local, "
              f"{topo['process_count']} process(es)")
        for d in topo["devices"]:
            print(f"    device {d['id']}: {d['device_kind']} "
                  f"({d['total_memory'] / 2**30:.1f} GiB, "
                  f"{d['sm_count']} SMs, sm_{d['capability']})")
        if report["env"]:
            print("  relevant env:")
            for k, v in report["env"].items():
                print(f"    {k}={v}")
        print("-" * 64)
        for c in report["checks"]:
            mark = "PASS" if c["passed"] else "FAIL"
            print(f"  [{mark}] {c['name']}: {c['detail']}")
        print("=" * 64)
        print("ALL CHECKS PASSED" if report["all_passed"]
              else "FAILURES PRESENT")
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    from tpu_hpc_torch.runtime import cleanup_distributed, init_distributed

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="check the card (default; none is a failure) or "
                   "only what the CPU can run")
    args = p.parse_args(argv)
    init_distributed(device=args.device, verbose=False)
    try:
        report = check_environment(verbose=True, device=args.device)
    finally:
        cleanup_distributed()
    return 0 if report["all_passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
