#!/usr/bin/env python3
"""Times the 16-bit paged prefill's two producers against each other on
the pages TMA boxes tile.

A pool of q's 16-bit dtype takes ``paged_prefill_wgmma_kernel`` (TMA
boxes, a page at a time) on pages of 8, 16, 32 or 64 tokens or a
multiple of 64, and ``paged_prefill_gather_kernel`` (a producer
warpgroup that gathers key by key) on every other page size. This
script builds, beside the default library, a variant of
``csrc/paged_attention.cu`` with ``-DTPUHPC_PREFILL_BOXES=0``, whose
route sends every page size to the gathering kernel, and launches both
through the same wrapper (``_build.use_library``):

    python3 docs/port/gather_vs_boxes.py

Cases: the 7B chunk (32 KV heads, group 1) and the GQA one (8 KV heads,
group 8) of 256 rows at start 256, head_dim 128, bf16 q and pool (and
f16 at the 7B shape), over pages of 8, 16, 32, 64 and 128 tokens, and of
12 (gathered by both libraries: the yardstick of the variant's cost).
Per case and library: the route the library names, the largest error
against the plain version and whether ``checks/tolerance.py``'s rule
holds, whether the two libraries' outputs are equal bit for bit, and
``device_ms`` (torch.profiler, the kernel's own time) read in turns
boxes, gather, gather, boxes, so a drift of the card over the call reads
as a drift and not as a difference; the bound and SDPA's device time
beside them (bounds from ``chip_smoke.prefill_case``). One JSON line per
case, then a summary line with the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

# (shape, kv heads, group, dtype)
SHAPES = (("7b", 32, 1, "bfloat16"), ("gqa", 8, 8, "bfloat16"),
          ("7b", 32, 1, "float16"))
PAGES = (8, 16, 32, 64, 128, 12)


def main() -> int:
    import torch

    import chip_smoke
    from tpu_hpc_torch.checks.roofline import chip_for_kind
    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import _build
    from tpu_hpc_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    build_s = _build.build()
    built = _build.build_variants({"prefill_gather_only":
                                   {"TPUHPC_PREFILL_BOXES": 0}},
                                  source="paged_attention.cu")
    variant = built["prefill_gather_only"]
    if isinstance(variant, Exception):
        raise variant
    libs = {"boxes": _build.load_library(),
            "gather": _build.load_variant(variant, "paged_attention.cu")}
    dev = torch.device("cuda", 0)
    chip_smoke.CHIP = chip_for_kind(torch.cuda.get_device_name(0))
    fn, ref = pa.paged_prefill_attention, pa.paged_prefill_attention_ref

    def run(name, f):
        if name == "boxes":
            return f()
        with _build.use_library(libs["gather"]):
            return f()

    summary = {"nvidia_smi": chip_smoke.nvidia_smi_line(),
               "build_s": build_s, "device_ms": {}}
    for shape, hkv, g, dname in SHAPES:
        dtype = getattr(torch, dname)
        for bs in PAGES:
            args, kw, (nb, fl) = chip_smoke.prefill_case(
                torch, dev, hkv, g, dname, 256, dtype, bs=bs)
            want = ref(*args, **kw)
            row = {"shape": shape, "dtype": dname, "block_size": bs}
            outs = {}
            for name in ("boxes", "gather"):
                outs[name] = run(name, lambda: fn(*args, **kw))
                c = compare(outs[name], want, dtype)
                row[name] = {
                    "route": run(name, lambda: pa.paged_prefill_route(
                        dtype, dtype, 128, bs)),
                    "max_abs_err": c["max_abs_err"], "rule_ok": c["ok"],
                    "device_ms": [],
                }
            torch.cuda.synchronize()
            row["bit_equal"] = bool(torch.equal(outs["boxes"],
                                                outs["gather"]))
            for name in ("boxes", "gather", "gather", "boxes"):
                row[name]["device_ms"].append(run(name, lambda: (
                    chip_smoke.device_ms(lambda: fn(*args, **kw),
                                         "paged_prefill"))))
            lib_fn = chip_smoke.library_prefill(torch, args, kw)
            row["bound_ms"], row["bound_by"] = chip_smoke.bound(nb, fl, dtype)
            row["library_device_ms"] = chip_smoke.device_ms(lib_fn, "")
            row.update(bytes=nb, flops=fl)
            print(json.dumps(row), flush=True)
            summary["device_ms"][f"{shape} {dname} pages of {bs}"] = {
                name: sum(row[name]["device_ms"]) / 2
                for name in ("boxes", "gather")}
            del args, kw, want, outs
            torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
