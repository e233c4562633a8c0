#!/usr/bin/env python3
"""Run chip_smoke.py's ``serve_tier_fleet`` phase alone, on one card:
the kernel library build, then (a) the host-DRAM KV tier at Llama-2-7B
(long_idle_sessions without and with the tier and on a roomy pool, and
the bf16 and int8 page round trips), (b) the fleet of two replicas on
the card at 7B width (clean, kill, clean swap, corrupt swap and the
controls) and (c) a trainer checkpoint restored into the serving layout
and used as the draft. A quicker check than the whole smoke after a
change to the tier, the fleet or the restore path.

    python3 docs/port/serve_tier_fleet_phase.py     # from the repo root

Prints chip_smoke's JSON lines and nvidia-smi's name and power limit;
exits non-zero on any failure, or without a CUDA device.
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
        print("serve_tier_fleet_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tpu_hpc_torch.checks.roofline import chip_for_kind
    from tpu_hpc_torch.kernels import _build
    from tpu_hpc_torch.models import llama2

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.CHIP = chip_for_kind(torch.cuda.get_device_name(0))
    cs.emit("device", nvidia_smi=smi, torch=torch.__version__,
            cuda=torch.version.cuda)
    cs.emit("build", seconds=_build.build())
    _build.load_library()
    dev = torch.device("cuda", 0)
    launches = cs.serve_tier_fleet_phase(
        torch, dev, llama2.PRESETS["7b"],
        os.path.join(ROOT, cs.RESTORE_DIR), cs.FLEET_LAYERS)
    cs.emit("serve_tier_fleet_launches", **launches)
    cs.emit("done", seconds=time.perf_counter() - t0)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
