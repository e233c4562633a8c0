#!/usr/bin/env python3
"""Times a clean build of the kernel library for each checkout named, in
turns, so that two ways of building the same kernels compare on one
host:

    python3 docs/port/build_time.py ROOT_A ROOT_B [--rounds N]

where each root holds a ``tpu_hpc_torch`` package (e.g. an older commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists).
Round 1 builds A then B, round 2 B then A, and so on (``--rounds``, 2),
each in a fresh process with that root's build directory removed first.
One JSON line per build: the root, the seconds ``_build.build()`` took,
the sources and nvcc's flags, and, from the ptxas report, the kernels'
count and how many of them spill (this checkout's
``chip_smoke.ptxas_summary`` reads it). Needs ``nvcc`` (the CUDA
toolkit); no card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BUILD = r"""
import json, shutil, sys
sys.path.insert(0, sys.argv[1])
from tpu_hpc_torch.kernels import _build
shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
seconds = _build.build()
print(json.dumps(dict(
    seconds=seconds, sources=[p.name for p in _build.sources()],
    flags=list(_build.COMPILE_FLAGS), ptxas_log=str(_build.PTXAS_LOG))))
"""


def build_once(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", BUILD, root],
                          capture_output=True, text=True, cwd=root)
    if proc.returncode != 0:
        raise SystemExit(f"build in {root} failed:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    sys.path.insert(0, REPO)
    from chip_smoke import ptxas_summary

    with open(out.pop("ptxas_log")) as f:
        rows = ptxas_summary(f.read())
    out.update(kernels=len(rows), spilling=sum(
        1 for r in rows if r["spill_stores"] or r["spill_loads"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    for n in range(args.rounds):
        for root in (roots if n % 2 == 0 else roots[::-1]):
            print(json.dumps(dict(round=n, root=root, **build_once(root))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
