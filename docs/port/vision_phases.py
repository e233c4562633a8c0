#!/usr/bin/env python3
"""Run chip_smoke.py's flash cases at the ViT's shape and its
train_vision, train_domain and train_long phases alone, on one card: the
kernel library build, the flash phase's ``vit_noncausal`` cases (and
``train_main`` beside them), the bench-Llama training run (whose
tokens/s train_long prints beside its own), then the three phases. A
quicker check than the whole smoke after a change to the vision models,
the domain transport or the flash kernels at head_dim 32.

    python3 docs/port/vision_phases.py     # from the repo root

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
        print("vision_phases: no CUDA device", file=sys.stderr)
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
    cs.FLASH_CASES = tuple(c for c in cs.FLASH_CASES if c[0] in (
        "train_main", "vit_noncausal", "vit_noncausal_ragged"))
    cs.flash_phase(torch, dev)
    _, train = cs.train_phase(torch, dev)
    cs._release(torch)
    phases = {}
    for name, fn, args in (("train_vision", cs.train_vision_phase, ()),
                           ("train_domain", cs.train_domain_phase, ()),
                           ("train_long", cs.train_long_phase, (train,))):
        t = time.perf_counter()
        fn(torch, dev, *args)
        cs._release(torch)
        phases[name] = time.perf_counter() - t
    cs.emit("done", seconds=time.perf_counter() - t0, phase_seconds=phases)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
