#!/usr/bin/env python3
"""Run chip_smoke.py's ``train`` and ``train_comm`` phases alone, on one
card: the kernel library build, the bench-Llama training run (whose
losses and tokens/s train_comm holds its own against), then the comm
layer's (a)-(d). A quicker check than the whole smoke after a change to
the comm layer.

    python3 docs/port/train_comm_phase.py     # from the repo root

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
        print("train_comm_phase: no CUDA device", file=sys.stderr)
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
    _, train = cs.train_phase(torch, dev)
    cs.emit("train_comm_launches", **cs.train_comm_phase(torch, dev, train))
    cs.emit("done", seconds=time.perf_counter() - t0)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
