#!/usr/bin/env python3
"""Two ablations of the kD 256 flash forward and dq of a checkout, timed
beside the checkout itself at Gemma-2B's training attention (rows 1G and
2G: B 1, S 2048, 8 query heads over 1 KV head of 256, causal, bf16):

  * ``stream``: every wgmma the two kernels issue returns at once (an
    SS product's accumulator comes out zero, an RS product's is left as
    it was); the ring, its TMA loads and barriers, the softmax and dS
    arithmetic stay. What is left is the time of the K/V stream from L2
    into shared memory over the grid, with the consumers' elementwise
    work beside it.
  * ``steps``: the ring loads K/V tile 0 once and every step of the walk
    reads it again (the forward's producer loads one tile, the walk and
    dq's loop read stage 0 and wait only on its first phase): the time
    of the steps alone, with no stream.

The ablated copies are made under ``build/ablate/<variant>/`` from the
checkout's own sources, patched as text (each patch must match the
expected number of times, or the script stops): nothing of them is in
the package, and their outputs are wrong by design. The three trees
are then timed in turns by ``hd256_retime.py --cases 1G,2G`` (ROOT,
stream, steps, steps, stream, ROOT), each building its own library.

    python3 docs/port/hd256_ablate.py ROOT

ROOT holds a ``tpu_hpc_torch`` package whose kD 256 forward and dq are
``flash_fwd_wgmma_kernel`` (walking ``hopper.cuh``'s ``walk``) and
``flash_dq_wgmma_kernel`` with its two-stage ring loaded by thread 0 --
the kernels before the head-group sharing (e.g. the parent commit
unpacked with ``git archive <commit> tpu_hpc_torch | tar -x -C
build/parent``).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

SS_HEAD = ("__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], "
           "uint64_t da,\n                                               "
           "uint64_t db, int scale_d) {\n")
RS_HEAD = ("__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],\n"
           "                                               const uint32_t "
           "(&a)[4], uint64_t db,\n                                        "
           "       int scale_d) {\n")
# (file, region start, region end or None, old, new, count)
PATCHES = {
    "stream": (
        ("hopper.cuh", None, None, SS_HEAD, SS_HEAD +
         "  if (scale_d >= 0) {\n    if (!scale_d)\n      for (int i = 0; "
         "i < 32; ++i) d[i] = 0.f;\n    return;\n  }\n", 1),
        ("hopper.cuh", None, None, RS_HEAD, RS_HEAD +
         "  if (scale_d >= 0) return;\n", 1),
    ),
    "steps": (
        # The walk: every tile is stage 0's, waited on at its first phase.
        ("hopper.cuh", "__device__ __forceinline__ void walk(",
         "// The finished rows",
         "    const int st = kt % ring.stages;\n"
         "    const int pst = (kt - 1) % ring.stages;\n"
         "    mbar_wait(ring.full_k + 8 * st, (kt / ring.stages) & 1);\n",
         "    const int st = 0;\n    const int pst = 0;\n", 1),
        ("hopper.cuh", "__device__ __forceinline__ void walk(",
         "// The finished rows",
         "mbar_wait(ring.full_v + 8 * pst, ((kt - 1) / ring.stages) & 1);",
         "mbar_wait(ring.full_v, 0);", 1),
        ("hopper.cuh", "__device__ __forceinline__ void walk(",
         "// The finished rows",
         "  const int lst = last % ring.stages;\n"
         "  mbar_wait(ring.full_v + 8 * lst, (last / ring.stages) & 1);\n",
         "  const int lst = 0;\n  mbar_wait(ring.full_v, 0);\n", 1),
        # The forward's producer loads tile 0 only.
        ("flash_attention.cu", "flash_fwd_wgmma_kernel(",
         "// Forward, float32 inputs",
         "for (int kt = 0; kt < n_kt; ++kt) {",
         "for (int kt = 0; kt < min(n_kt, 1); ++kt) {", 1),
        # dq: no load past tile 0, every step on stage 0.
        ("flash_attention.cu", "flash_dq_wgmma_kernel(",
         "// A dk/dv block's epilogue",
         "    const int st = kt & 1;\n"
         "    if (threadIdx.x == 0 && kt + 1 < n_kt) {",
         "    const int st = 0;\n    if (false) {", 1),
        ("flash_attention.cu", "flash_dq_wgmma_kernel(",
         "// A dk/dv block's epilogue",
         "mbar_wait(bar_ring + 8 * st, (kt >> 1) & 1);",
         "mbar_wait(bar_ring, 0);", 1),
    ),
}


def patched(text: str, start, end, old: str, new: str, count: int,
            where: str) -> str:
    lo = 0 if start is None else text.index(start)
    hi = len(text) if end is None else text.index(end, lo)
    region = text[lo:hi]
    found = region.count(old)
    if found != count:
        raise SystemExit(f"{where}: expected {count} of {old!r}, found "
                         f"{found} -- the source changed; update PATCHES")
    return text[:lo] + region.replace(old, new) + text[hi:]


def make_variant(root: str, name: str) -> str:
    dst = os.path.join(REPO, "build", "ablate", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "tpu_hpc_torch"),
                    os.path.join(dst, "tpu_hpc_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "tpu_hpc_torch", "csrc")
    for fname, start, end, old, new, count in PATCHES[name]:
        path = os.path.join(csrc, fname)
        with open(path) as f:
            text = f.read()
        text = patched(text, start, end, old, new, count,
                       f"{name}/{fname}")
        with open(path, "w") as f:
            f.write(text)
    return dst


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(argv[0])
    roots = [root] + [make_variant(root, name) for name in PATCHES]
    return subprocess.call([sys.executable,
                            os.path.join(HERE, "hd256_retime.py"),
                            "--cases", "1G,2G", *roots])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
