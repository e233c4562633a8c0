#!/usr/bin/env python3
"""Times the three flash kernels of two checkouts in one call.

The training path's shape (B 4, S 2048, 8 heads, head_dim 128, causal,
bf16) and chip_smoke.py's float32 case (B 1, S 1000, 8 heads, head_dim
128, causal: the split-TF32 kernels, keys ending ``_float32``). Each
checkout builds its own library (``<root>/build``) and is
timed in its own process, in turns A, B, B, A, so a drift of the card
over the call reads as a drift and not as a difference:

    python3 docs/port/flash_retime.py OLD_ROOT NEW_ROOT

where each root holds a ``tpu_hpc_torch`` package (e.g. an older
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists). Per kernel: ``ms`` from CUDA events over back-to-back calls and
``device_ms`` from torch.profiler (the kernel's own device time). One
JSON line per reading, then a summary line with each root's mean.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ITERS = 50
SHAPE = (4, 2048, 8, 128)
SHAPE_F32 = (1, 1000, 8, 128)

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from tpu_hpc_torch.kernels import _build, attention as fa

build_s = _build.build()
dev = torch.device("cuda", 0)
calls = {}
for suffix, shape, dtype in (("", SHAPE, torch.bfloat16),
                             ("_float32", SHAPE_F32, torch.float32)):
    b, s, h, d = shape
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    dm = (do.float() * out.float()).sum(-1)
    bargs = (q, k, v, do, lse, dm)
    calls["flash_attention_fwd" + suffix] = (
        "flash_fwd", lambda q=q, k=k, v=v: fa.flash_attention_fwd(q, k, v))
    calls["flash_attention_dq" + suffix] = (
        "flash_dq", lambda a=bargs: fa.flash_attention_dq(*a))
    calls["flash_attention_dkv" + suffix] = (
        "flash_dkv", lambda a=bargs: fa.flash_attention_dkv(*a))
row = {"root": sys.argv[1], "build_s": build_s}
for name, (kernel, fn) in calls.items():
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(ITERS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key)
    row[name] = {"ms": e0.elapsed_time(e1) / ITERS,
                 "device_ms": dev_us / 1e3 / ITERS}
print(json.dumps(row))
"""


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(r) for r in argv)
    code = (f"SHAPE = {SHAPE}\nSHAPE_F32 = {SHAPE_F32}\nITERS = {ITERS}\n"
            + CHILD)
    readings = []
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, "-c", code, root],
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        readings.append(row)
    summary = {}
    for root in (a, b):
        rows = [r for r in readings if r["root"] == root]
        summary[root] = {
            k: {m: sum(r[k][m] for r in rows) / len(rows)
                for m in ("ms", "device_ms")}
            for k in rows[0] if k.startswith("flash_")}
    print(json.dumps({"summary": summary, "shape": SHAPE,
                      "shape_float32": SHAPE_F32, "iters": ITERS}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
