#!/usr/bin/env python3
"""Run chip_smoke.py's ``ops`` phase alone, on one card: the kernel
library build, the single-tier ``serve`` and ``serve_int8`` replays whose
greedy tokens (a) is held to, then (a) the 7B's disaggregated replays
with both tiers on this card (bf16 and int8 pools) and the wrong-page-id
control, (b) the reshard engine on the
bench Llama's TrainState, and (c) the elastic coordinator's storm on
the bench Llama. A quicker check than the whole smoke after a change to
reshard/, elastic/ or serve/disagg.py.

    python3 docs/port/ops_phase.py     # from the repo root

Prints chip_smoke's JSON lines and nvidia-smi's name and power limit;
exits non-zero on any failure, or without a CUDA device.
"""
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ops_phase: no CUDA device", file=sys.stderr)
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
    _build.load_library()
    dev = torch.device("cuda", 0)
    cfg, serve_cfg, paged = cs.serve_shape()
    with cs.recorded_runs() as runs:
        cs.serve_phase(torch, dev, "serve", cfg, serve_cfg, paged)
        cs.serve_phase(torch, dev, "serve_int8", cfg, serve_cfg,
                       dataclasses.replace(paged, kv_quant="int8"))
    cs._release(torch)
    launches = cs.ops_phase(torch, dev, cfg, serve_cfg, paged, *runs)
    cs.emit("ops_launches", **launches)
    cs.emit("done", seconds=time.perf_counter() - t0)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
