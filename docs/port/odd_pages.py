#!/usr/bin/env python3
"""Times the paged prefill over pages TMA boxes cannot tile, for two
checkouts in one call.

The 7B chunk of 256 at start 256 (32 KV heads, group 1, head_dim 128)
over pages of 12 and of 250 tokens, for float32 q and pool, bf16 q and
pool, and an int8 pool under a bf16 q; beside them the same pairs over
16-token pages (the TMA-tiled routes) and a float32 chunk at head_dim 72
over 12-token pages (outside the tensor-core rule). Each checkout builds
its own library (``<root>/build``) and is timed in its own process, in
turns A, B, B, A, so a drift of the card over the call reads as a drift
and not as a difference:

    python3 docs/port/odd_pages.py OLD_ROOT NEW_ROOT

where each root holds a ``tpu_hpc_torch`` package (e.g. an older commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists);
the cases and their bounds come from this checkout's ``chip_smoke.py``.
Per case: the route the library names, ``ms`` (CUDA events over
back-to-back calls, wrapper included), ``device_ms`` (torch.profiler,
the kernel's own time), the largest error against the plain version and
whether ``checks/tolerance.py``'s rule holds, whether the output equals
the same keys through 16-token pages bit for bit (16-bit and float32
pools), SDPA's time over the gathered pages and the bound; a launch the
library refuses is recorded with its error. One JSON line per reading,
then a summary line with each root's mean device ms per case.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# (name, pool, q dtype, page tokens, head_dim)
CASES = (
    ("f32_pages_of_16", "float32", "float32", 16, 128),
    ("bf16_pages_of_16", "bfloat16", "bfloat16", 16, 128),
    ("int8_pages_of_16", "int8", "bfloat16", 16, 128),
    ("f32_pages_of_12", "float32", "float32", 12, 128),
    ("bf16_pages_of_12", "bfloat16", "bfloat16", 12, 128),
    ("int8_pages_of_12", "int8", "bfloat16", 12, 128),
    ("f32_pages_of_250", "float32", "float32", 250, 128),
    ("bf16_pages_of_250", "bfloat16", "bfloat16", 250, 128),
    ("int8_pages_of_250", "int8", "bfloat16", 250, 128),
    ("f32_head_dim_72", "float32", "float32", 12, 72),
)

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, REPO)
import torch
import chip_smoke
from tpu_hpc_torch.checks.roofline import chip_for_kind
from tpu_hpc_torch.checks.tolerance import compare, rule_dtype
from tpu_hpc_torch.kernels import _build
from tpu_hpc_torch.kernels import paged_attention as pa

build_s = _build.build()
dev = torch.device("cuda", 0)
chip_smoke.CHIP = chip_for_kind(torch.cuda.get_device_name(0))
ptxas = [r for r in chip_smoke.ptxas_summary(_build.PTXAS_LOG.read_text())
         if r["kernel"].startswith("paged_prefill")]
row = {"root": sys.argv[1], "build_s": build_s, "ptxas": ptxas,
       "nvidia_smi": chip_smoke.nvidia_smi_line()}
fn, ref = pa.paged_prefill_attention, pa.paged_prefill_attention_ref
for name, pool, q_name, bs, d in CASES:
    q_dtype = getattr(torch, q_name)
    args, kw, (nb, fl) = chip_smoke.prefill_case(
        torch, dev, 32, 1, pool, 256, q_dtype, bs=bs, d=d)
    r = {"route": pa.PREFILL_ROUTES[_build.load_library().tpuhpc_prefill_route(
        d, bs, pa.DTYPE_CODES[q_dtype], pa.DTYPE_CODES[args[1].dtype])]}
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
    if pool != "int8" and bs != 16:
        a16, kw16 = chip_smoke.repaged(torch, args, kw, 16)
        r["bit_equal_to_pages_of_16"] = bool(torch.equal(out, fn(*a16, **kw16)))
    if pool == "float32" and d == 128:
        r["bound_ms"], r["bound_by"] = chip_smoke.bound_tf32(nb, fl, q_name,
                                                             pool)
    else:
        r["bound_ms"], r["bound_by"] = chip_smoke.bound(nb, fl, q_dtype)
    lib_fn = chip_smoke.library_prefill(torch, args, kw)
    r.update(ms=chip_smoke.time_ms(lambda: fn(*args, **kw), iters=50),
             device_ms=chip_smoke.device_ms(lambda: fn(*args, **kw),
                                            "paged_prefill"),
             library_ms=chip_smoke.time_ms(lib_fn, iters=50),
             library_device_ms=chip_smoke.device_ms(lib_fn, ""),
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
