#!/usr/bin/env python3
"""The phases of ``chip_smoke.py`` that the split-TF32 flash backward
runs through, alone, on one card:

    python3 docs/port/tf32_backward_phases.py [kernels] [flash] [crosscheck] [nonfinite]

(all four without arguments). Builds the kernel library (one JSON line
with every TF32 kernel's registers and spills), then: ``kernels`` -- the
paged kernel cases, the prefill's scalar route at the 7B chunk on
12-token pages among them; ``flash`` -- every flash case, the float32
one with its TF32-route rows (repeated last, one line each, with the
keys of the summary's ``tf32_route``); ``crosscheck`` --
train_crosscheck, with the flash kernels' launches; ``nonfinite`` -- the
planted NaN and inf cases of the flash kernels in bf16 and float32. The
first line is nvidia-smi's name and power limit; the last the seconds.
About two minutes of command with the build.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpu_hpc_torch.checks.roofline import chip_for_kind
    from tpu_hpc_torch.kernels import _build

    if not torch.cuda.is_available():
        print("tf32_backward_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    cs.CHIP = chip_for_kind(torch.cuda.get_device_name(0))
    print(cs.nvidia_smi_line(), flush=True)
    build_s = _build.build()
    lib = _build.load_library()
    ptxas = cs.ptxas_summary(_build.PTXAS_LOG.read_text())
    cs.emit("build", seconds=build_s,
            tf32=[r for r in ptxas if "tf32" in r["kernel"]])
    phases = sys.argv[1:] or ["kernels", "flash", "crosscheck", "nonfinite"]
    ok = True
    if "kernels" in phases:
        cs.kernel_phase(torch, dev, lib)
    if "flash" in phases:
        _, timed = cs.flash_phase(torch, dev)
        for name, row in timed["float32"].items():
            print(json.dumps({"f32_row": name, **{
                k: row.get(k) for k in cs.TF32_ROW_KEYS}}), flush=True)
    if "crosscheck" in phases:
        print(json.dumps({"cross_launches":
                          cs.train_crosscheck_phase(torch, dev)}), flush=True)
    if "nonfinite" in phases:
        for dtype in (torch.bfloat16, torch.float32):
            for r in cs.flash_nonfinite(torch, dev, dtype):
                cs.emit("nonfinite", **r)
                ok = ok and r["ok"]
    print(json.dumps({"ok": ok, "seconds": time.perf_counter() - t0}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
