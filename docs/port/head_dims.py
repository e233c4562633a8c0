#!/usr/bin/env python3
"""Times the paged kernels at head dims off the 128-column kernels, for
two checkouts in one call.

Cases (``CASES``): the 7B chunk of 256 at start 256 (32 KV heads, group
1) at head_dim 72 for float32 (PERF.md row 5d), bf16 and an int8 pool
under bf16, and at 36 for bf16; Gemma-2B's attention (1 KV head, group
8, head_dim 256) for the same chunk over bf16 (16- and 12-token pages),
int8 under bf16 and float32, and its decode (chip_smoke.decode_case's 8
slots) over bf16 and int8; and, as controls that neither checkout's
change should move, the 7B chunk at head_dim 128 over bf16 (16- and
12-token pages), int8 and float32, and the 7B decode over bf16.
Each checkout builds its own library (``<root>/build``) and is timed in
its own process, in turns A, B, B, A, so a drift of the card over the
call reads as a drift and not as a difference:

    python3 docs/port/head_dims.py OLD_ROOT NEW_ROOT

where each root holds a ``tpu_hpc_torch`` package (e.g. an older commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists);
the cases, their inputs and bounds come from this checkout's
``chip_smoke.py``. Per case: the route the library names (the decode:
``split``), ``ms`` (CUDA events over back-to-back calls, wrapper
included), ``device_ms`` (torch.profiler, the kernels' own time), the
largest error against the plain version and whether
``checks/tolerance.py``'s rule holds, SDPA's time over the gathered
pages and the bound (the TF32 route's at the TF32 rate for its split
passes; float32 elsewhere at the fp32 FMA rate); a launch the wrapper or
the library refuses is recorded with its error. One JSON line per
reading, then a summary line with each root's device ms per case.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# (name, kernel, (kv heads, group), pool, q dtype, page tokens, head_dim)
CASES = (
    ("f32_head_dim_72", "prefill", (32, 1), "float32", "float32", 16, 72),
    ("bf16_head_dim_72", "prefill", (32, 1), "bfloat16", "bfloat16", 16, 72),
    ("int8_head_dim_72", "prefill", (32, 1), "int8", "bfloat16", 16, 72),
    ("bf16_head_dim_36", "prefill", (32, 1), "bfloat16", "bfloat16", 16, 36),
    ("gemma_bf16", "prefill", (1, 8), "bfloat16", "bfloat16", 16, 256),
    ("gemma_bf16_pages_of_12", "prefill", (1, 8), "bfloat16", "bfloat16",
     12, 256),
    ("gemma_int8", "prefill", (1, 8), "int8", "bfloat16", 16, 256),
    ("gemma_f32", "prefill", (1, 8), "float32", "float32", 16, 256),
    ("gemma_decode_bf16", "decode", (1, 8), "bfloat16", "bfloat16", 16, 256),
    ("gemma_decode_int8", "decode", (1, 8), "int8", "bfloat16", 16, 256),
    ("bf16_head_dim_128", "prefill", (32, 1), "bfloat16", "bfloat16", 16,
     128),
    ("bf16_pages_of_12_head_dim_128", "prefill", (32, 1), "bfloat16",
     "bfloat16", 12, 128),
    ("int8_head_dim_128", "prefill", (32, 1), "int8", "bfloat16", 16, 128),
    ("f32_head_dim_128", "prefill", (32, 1), "float32", "float32", 16, 128),
    ("decode_bf16_head_dim_128", "decode", (32, 1), "bfloat16", "bfloat16",
     16, 128),
)

CHILD = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import torch
# This checkout's chip_smoke (its cases and bounds), the root's kernels.
spec = importlib.util.spec_from_file_location(
    "chip_smoke", REPO + "/chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
from tpu_hpc_torch.checks.roofline import chip_for_kind
from tpu_hpc_torch.checks.tolerance import compare, rule_dtype
from tpu_hpc_torch.kernels import _build
from tpu_hpc_torch.kernels import paged_attention as pa

build_s = _build.build()
lib = _build.load_library()
dev = torch.device("cuda", 0)
chip_smoke.CHIP = chip_for_kind(torch.cuda.get_device_name(0))
ptxas = [r for r in chip_smoke.ptxas_summary(_build.PTXAS_LOG.read_text())
         if r["kernel"].startswith("paged_")]
row = {"root": sys.argv[1], "build_s": build_s, "ptxas": ptxas,
       "nvidia_smi": chip_smoke.nvidia_smi_line()}
for name, kernel, (hkv, g), pool, q_name, bs, d in CASES:
    q_dtype = getattr(torch, q_name)
    if kernel == "decode":
        args, kw, (nb, fl) = chip_smoke.decode_case(
            torch, dev, hkv, g, pool == "int8", d=d)
        fn, ref = pa.paged_decode_attention, pa.paged_decode_attention_ref
        lib_fn, kname, route = chip_smoke.library_decode, "paged_decode", "split"
    else:
        args, kw, (nb, fl) = chip_smoke.prefill_case(
            torch, dev, hkv, g, pool, 256, q_dtype, bs=bs, d=d)
        fn, ref = pa.paged_prefill_attention, pa.paged_prefill_attention_ref
        lib_fn, kname = chip_smoke.library_prefill, "paged_prefill"
        route = pa.PREFILL_ROUTES[lib.tpuhpc_prefill_route(
            d, bs, pa.DTYPE_CODES[q_dtype], pa.DTYPE_CODES[args[1].dtype])]
    r = {"route": route}
    try:
        out = fn(*args, **kw)
        torch.cuda.synchronize()
    except Exception as e:  # the launch refused: recorded, not timed
        r["error"] = str(e)[:300]
        row[name] = r
        continue
    want = ref(*args, **kw)
    gate = rule_dtype(q_dtype, None if pool == "int8" else args[1].dtype)
    c = compare(out, want, gate)
    r.update(max_abs_err=c["max_abs_err"], rule_ok=c["ok"],
             tol_used=c["tol_used"])
    if route == "wgmma_tf32":
        r["bound_ms"], r["bound_by"] = chip_smoke.bound_tf32(nb, fl, q_name,
                                                             pool)
    else:
        r["bound_ms"], r["bound_by"] = chip_smoke.bound(nb, fl, q_dtype)
    lib_call = lib_fn(torch, args, kw)
    r.update(ms=chip_smoke.time_ms(lambda: fn(*args, **kw), iters=50),
             device_ms=chip_smoke.device_ms(lambda: fn(*args, **kw), kname),
             library_ms=chip_smoke.time_ms(lib_call, iters=50),
             library_device_ms=chip_smoke.device_ms(lib_call, ""),
             bytes=nb, flops=fl)
    row[name] = r
    del args, kw, out, want
    torch.cuda.empty_cache()
print(json.dumps(row))
"""


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(r) for r in argv)
    code = f"REPO = {REPO!r}\nCASES = {CASES!r}\n" + CHILD
    readings = []
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, "-c", code, root],
                             capture_output=True, text=True, timeout=900)
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
            name: [r[name].get("device_ms") for r in rows]
            for name, *_ in CASES}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
