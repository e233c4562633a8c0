#!/usr/bin/env python3
"""Run chip_smoke.py's ``obs_capture`` phase alone, on one card: the
kernel library build, then (a) Llama-2-7B serving the ``colocate``
scenario through run_loadgen with ``--capture-dir``'s capture (one
capture on a stall, a torch.profiler window that sees the paged kernels
by name at the counts their wrappers give, the device_memory record,
the trace analyzer's acceptance bundle) and its two controls, and (b)
the bench Llama with ``profile`` (the flash kernels counted in the
window) and with ``capture_on_anomaly`` under the straggler fault. A
quicker check than the whole smoke after a change to obs/, profiling/
or the entry points that arm them.

    python3 docs/port/obs_capture_phase.py     # from the repo root

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
        print("obs_capture_phase: no CUDA device", file=sys.stderr)
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
    launches = cs.obs_capture_phase(torch, dev, *cs.serve_shape())
    cs.emit("obs_capture_launches", **launches)
    cs.emit("done", seconds=time.perf_counter() - t0)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
