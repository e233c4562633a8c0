#!/usr/bin/env python3
"""The bench-Llama profile window of chip_smoke.py's ``obs_capture`` (b),
run again and again in one process on one card, with each window's
trace taken apart: does every flash kernel the wrappers launched inside
the window appear in the trace as a device event, and if not, which
launch is missing and what ran around it.

    python3 docs/port/profiler_repeat.py [--windows N] [--history H]
        [--cudart-shared N]

Before the windows, ``H`` short ``torch.profiler`` sessions (chip_smoke's
``device_ms`` over the kD 128 flash forward, as the smoke's kernel
phases open dozens before ``obs_capture``) age the process's profiler
the way the smoke's run does. Each window is chip_smoke's own
(``obs_train_run(profile=True)``: the bench Llama through
``Trainer.fit``, 5 updates, the window over updates 2-3, 128 launches of
each flash kernel in it). Per window one JSON line: the wrappers'
launches in the window, the trace's device events by kernel (the gate:
they must be equal), and the trace's own bookkeeping -- kernel events,
runtime launch calls (``cuda_runtime`` events whose name holds
``Launch``), the correlation ids on either side that the other lacks,
and for each launch with no kernel event its offset into the window and
the kernels launched just before and after it. A summary line counts
windows and lost events. A window of a package whose profiler opens
with sentinel kernels (``profiling/profiler.py``'s ``SENTINEL_KERNELS``
one-element fills, launched first) may lose those; a launch past them
without its kernel event fails the window. ``--cudart-shared N`` then
runs N more windows
with the flash kernels launched from a library built like the default
one but linked against the shared CUDA runtime (``nvcc -cudart
shared``, the libcudart PyTorch itself loads; the default build links
nvcc's static runtime into the library): a check of whether the second
runtime instance is what the profiler loses. Exits 1 if any window lost
an event. The traces (about 55 MB each) are removed after reading.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def trace_bookkeeping(path: str) -> dict:
    """Kernel events and runtime launch calls of a Chrome trace, matched
    by correlation id."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "Launch" in e.get("name", "")]
    k_corr = {e.get("args", {}).get("correlation"): e for e in kernels}
    l_corr = {e.get("args", {}).get("correlation"): e for e in launches}
    t0 = min(e["ts"] for e in events if "ts" in e and e.get("ph") == "X")
    order = sorted(launches, key=lambda e: e["ts"])

    def kernel_of(e):
        k = k_corr.get(e.get("args", {}).get("correlation"))
        return None if k is None else k["name"][:60]

    lost = []
    for i, e in enumerate(order):
        if e.get("args", {}).get("correlation") in k_corr:
            continue
        lost.append({
            "launch": e["name"], "correlation": e["args"].get("correlation"),
            "offset_us": e["ts"] - t0, "index": i,
            "before": [kernel_of(x) for x in order[max(0, i - 3):i]],
            "after": [kernel_of(x) for x in order[i + 1:i + 4]]})
    orphans = [{"name": e["name"][:60], "correlation":
                e.get("args", {}).get("correlation")}
               for e in kernels
               if e.get("args", {}).get("correlation") not in l_corr]
    first = [kernel_of(x) for x in order[:12]]
    return {"kernel_events": len(kernels), "runtime_launches": len(launches),
            "launch_names": sorted({e["name"] for e in launches}),
            "launches_without_kernel": lost,
            "kernels_without_launch": orphans[:10],
            "n_kernels_without_launch": len(orphans),
            "first_kernels": first}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--history", type=int, default=60)
    ap.add_argument("--cudart-shared", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profiler_repeat: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tpu_hpc_torch.checks.roofline import chip_for_kind
    from tpu_hpc_torch.kernels import _build
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.profiling import profiler

    t_start = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.CHIP = chip_for_kind(torch.cuda.get_device_name(0))
    cs.emit("device", nvidia_smi=smi, torch=torch.__version__,
            cuda=torch.version.cuda)
    cs.emit("build", seconds=_build.build())
    _build.load_library()
    dev = torch.device("cuda", 0)

    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((4, 2048, 8, 128), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    t0 = time.perf_counter()
    for _ in range(args.history):
        cs.device_ms(lambda: fa.flash_attention_fwd(q, k, v), "flash_fwd",
                     iters=5)
    cs.emit("history", sessions=args.history,
            seconds=time.perf_counter() - t0)
    del q, k, v
    torch.cuda.empty_cache()

    sentinels = getattr(profiler, "SENTINEL_KERNELS", 0)
    names = tuple(cs.FLASH_DEVICE_KERNELS.values())
    bad = 0
    lost_total = {n: 0 for n in names}
    lost_shared = {n: 0 for n in names}
    shared = None
    if args.cudart_shared:
        import subprocess

        out = _build.BUILD_DIR / "cudart_shared" / "lib.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, "-cudart", "shared",
               "-shared", "-o", str(out),
               str(_build.SOURCE_DIR / "flash_attention.cu")]
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        shared = _build.load_variant(out)
        cs.emit("build_cudart_shared", seconds=time.perf_counter() - t0)
    for w in range(args.windows + args.cudart_shared):
        variant = w >= args.windows
        ctx = (_build.use_library(shared) if variant
               else contextlib.nullcontext())
        work = os.path.join(ROOT, cs.OBS_DIR, f"repeat{w}")
        with ctx:
            run = cs.obs_train_run(torch, dev, cs.OBS_PROFILE_UPDATES,
                                   profile=True, workdir=work)
        win = run["windows"][0]
        reading = cs.window_reading(win, names)
        book = trace_bookkeeping(win["trace_path"])
        lost = {kname: reading["launched"][wrapper]
                - reading["device_events"][kname]
                for wrapper, kname in cs.FLASH_DEVICE_KERNELS.items()}
        for kname, n in lost.items():
            (lost_shared if variant else lost_total)[kname] += n
        # A window opens with SENTINEL_KERNELS fills (launches 0 ..
        # SENTINEL_KERNELS - 1): a launch past them without its kernel
        # event is one of the owner's.
        owners_lost = [x for x in book["launches_without_kernel"]
                       if x["index"] >= sentinels]
        failed = any(lost.values()) or bool(owners_lost) or any(
            reading["launched"][w_] < 1 for w_ in cs.FLASH_DEVICE_KERNELS)
        bad += failed
        cs.emit("window", index=w, cudart_shared=variant,
                sentinel_kernels=sentinels,
                launches_lost=len(book["launches_without_kernel"]),
                owners_launches_lost=len(owners_lost),
                launched=reading["launched"],
                device_events=reading["device_events"], lost=lost,
                start_s=reading["start_s"],
                stop_export_s=reading["stop_export_s"], **book)
        shutil.rmtree(work, ignore_errors=True)
    cs.emit("profiler_repeat", windows=args.windows, windows_lost=bad,
            lost_events=lost_total, cudart_shared_windows=args.cudart_shared,
            cudart_shared_lost_events=lost_shared, history=args.history,
            seconds=time.perf_counter() - t_start, nvidia_smi=smi)
    print(smi)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
