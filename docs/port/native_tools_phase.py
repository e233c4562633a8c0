#!/usr/bin/env python3
"""Run chip_smoke.py's ``native_tools`` phase alone, on one card: the
kernel library build, the ``train`` phase (the TokenStream run the
token-file run is read beside), then (a) the bench Llama from a corpus
of the repo's own Markdown through the C++ reader, (b) the fit analyzer
against (a)'s live state, (c) the environment checks and the doctor,
(d) the autotuner's decode, forward and gradient sweeps. A quicker
check than the whole smoke after a change to native/, checks/,
runtime/tuning.py or kernels/autotune.py.

    python3 docs/port/native_tools_phase.py     # from the repo root

Prints chip_smoke's JSON lines (the autotune tables on stderr) and
nvidia-smi's name and power limit; exits non-zero on any failure, or
without a CUDA device.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("native_tools_phase: no CUDA device", file=sys.stderr)
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
    torch.cuda.empty_cache()
    launches = cs.native_tools_phase(torch, dev, train)
    cs.emit("native_tools_launches", **launches)
    cs.emit("done", seconds=time.perf_counter() - t0)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
