#!/usr/bin/env python3
"""The kD 256 forward and dq at each cluster size, each case in a process
of its own under a time limit: a first check of the clustered kernels on
a card, where a barrier that never completes would otherwise hang the
whole run.

    python3 docs/port/cluster_cases.py [--timeout S]

Builds the library once, prints nvcc's registers and spills for the kD
256 forward and dq, then per case (kernel, shape, cluster) one JSON
line: ``ok`` (the output within ``checks/tolerance.py``'s rule of the
plain version, bit-identical to the same call at cluster 1), the largest
error, or ``hung`` / the child's error. Exits 1 if any case failed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# (kernel, b, s, hq, hkv, d, cluster, q_offset, kv_offset)
CASES = [
    (kernel, b, s, hq, hkv, d, c, qo, ko)
    for kernel in ("fwd", "dq")
    for (b, s, hq, hkv, d, qo, ko) in ((1, 200, 8, 1, 256, 5, 21),
                                        (1, 200, 4, 2, 136, 0, 0),
                                        (1, 2048, 8, 1, 256, 0, 0))
    for c in (1, 2, 8) if (hq // hkv) % c == 0
]

CHILD = r"""
import json, sys
sys.path.insert(0, ROOT)
import torch
from tpu_hpc_torch.checks.tolerance import compare
from tpu_hpc_torch.kernels import attention as fa
kernel, b, s, hq, hkv, d, c, qo, ko = json.loads(sys.argv[1])
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(3)
rnd = lambda *sh: torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
q, k, v, dout = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), \
    rnd(b, s, hq, d)
if kernel == "fwd":
    got = fa.flash_attention_fwd(q, k, v, qo, ko, cluster=c)[0]
    one = fa.flash_attention_fwd(q, k, v, qo, ko, cluster=1)[0]
    want = fa.flash_attention_fwd_ref(q, k, v, qo, ko)[0]
else:
    o, lse = fa.flash_attention_fwd_ref(q, k, v, qo, ko)
    dlse = torch.randn((b, s, hq), generator=g, device=dev)
    dm = (dout.float() * o.float()).sum(-1) - dlse
    args = (q, k, v, dout, lse, dm, qo, ko)
    got = fa.flash_attention_dq(*args, cluster=c)
    one = fa.flash_attention_dq(*args, cluster=1)
    want = fa.flash_attention_dq_ref(*args)
torch.cuda.synchronize()
r = compare(got, want, torch.bfloat16)
print(json.dumps({"max_abs_err": r["max_abs_err"], "rule_ok": r["ok"],
                  "same_as_cluster_1": bool(torch.equal(got, one))}))
"""


def main(argv) -> int:
    timeout = 60
    if argv[:1] == ["--timeout"]:
        timeout = int(argv[1])
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tpu_hpc_torch.kernels import _build

    print(json.dumps({"build_s": _build.build(),
                      "nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    for r in cs.ptxas_summary(_build.PTXAS_LOG.read_text()):
        if r["kernel"].startswith(("flash_fwd_wgmma_kernel<bf16, 256",
                                   "flash_dq_gqa_kernel<bf16")):
            print(json.dumps(r), flush=True)
    code = f"ROOT = {ROOT!r}\n" + CHILD
    bad = 0
    for case in CASES:
        row = dict(zip(("kernel", "b", "s", "hq", "hkv", "d", "cluster",
                        "q_offset", "kv_offset"), case))
        try:
            out = subprocess.run([sys.executable, "-c", code,
                                  json.dumps(case)], capture_output=True,
                                 text=True, timeout=timeout)
            if out.returncode:
                row["error"] = out.stderr.strip().splitlines()[-1][:300]
            else:
                row.update(json.loads(out.stdout.strip().splitlines()[-1]))
        except subprocess.TimeoutExpired:
            row["hung"] = True
        ok = row.get("rule_ok") and row.get("same_as_cluster_1") is not None
        bad += not ok
        print(json.dumps(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
