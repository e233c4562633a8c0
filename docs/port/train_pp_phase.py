#!/usr/bin/env python3
"""Run chip_smoke.py's ``train`` and ``train_pp`` phases alone, on one
card, with the paged kernels' new non-finite cases: the kernel library
build, the decode (bf16 and int8 pools) and the prefill (the 16-bit and
scalar routes) with NaN and inf planted, against their plain versions;
the bench-Llama training run (whose tokens/s train_pp prints beside its
own); then pipeline parallelism (a) and (b). A quicker check than the
whole smoke after a change to the pipeline.

    python3 docs/port/train_pp_phase.py     # from the repo root

Prints chip_smoke's JSON lines and nvidia-smi's name and power limit;
exits non-zero on any failure, or without a CUDA device.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_pp_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tpu_hpc_torch.checks.roofline import chip_for_kind
    from tpu_hpc_torch.kernels import _build

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.CHIP = chip_for_kind(torch.cuda.get_device_name(0))
    cs.emit("device", nvidia_smi=smi, torch=torch.__version__,
            cuda=torch.version.cuda)
    cs.emit("build", seconds=_build.build())
    dev = torch.device("cuda", 0)
    bad = []
    for check, fn in (("decode_nonfinite", cs.decode_nonfinite),
                      ("prefill_nonfinite", cs.prefill_nonfinite)):
        for row in fn(torch, dev):
            cs.emit("train_resilience", check=check, **row)
            if not row["ok"]:
                bad.append(f"{check} {row['case']}")
    if bad:
        raise SystemExit("non-finite cases failed: " + ", ".join(bad))
    _, train = cs.train_phase(torch, dev)
    cs.emit("train_pp_launches", **cs.train_pp_phase(torch, dev, train))
    cs.emit("done", seconds=time.perf_counter() - t0)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
