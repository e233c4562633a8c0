#!/usr/bin/env python3
"""Design sweep of the paged decode kernel on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 docs/port/decode_sweep.py

It builds tpu_hpc_torch/csrc/paged_attention.cu as it stands and as a
few variants that change one constant of the decode (ring stages, keys
per key group, threads per block, rows per block), each into its own
library under build/decode_sweep/, and prints one JSON line per
measurement:

  * ``probe``: what a plain streaming read (``x.sum()``) and copy of 128
    MB reach on this card, the practical ceiling of a bytes-bound kernel;
  * ``case``: the device time (torch.profiler) of the split and combine
    kernels at chip_smoke.py's four decode shapes, for each variant and
    run count (``n_split``, the C entry's argument; ``auto`` marks the
    count the library picks), with the output held to the bf16 rule;
  * ``contiguous``: the 7B case's bytes laid out one head per slot, so
    each page of a head is contiguous (the pool strides a head's rows by
    kv_heads x d), to see whether the pool's layout costs bandwidth;
  * ``alone``: slot 0 of the 7B case alone (64 pages, 32 head blocks),
    the rate of a block's own walk.

Numbers are for the card it ran on (name and power limit printed first).
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from tpu_hpc_torch.checks.roofline import chip_for_kind  # noqa: E402
from tpu_hpc_torch.checks.tolerance import compare  # noqa: E402
from tpu_hpc_torch.kernels import _build  # noqa: E402
from tpu_hpc_torch.kernels import paged_attention as pa  # noqa: E402
from tpu_hpc_torch.kernels.attention import DTYPE_CODES  # noqa: E402

VARIANTS = {
    "base": [],
    "stages2": [("kDecodeStages = 4;", "kDecodeStages = 2;")],
    "stages8": [("kDecodeStages = 4;", "kDecodeStages = 8;")],
    "keys2": [("kDecodeKeysPerGroup = 4;", "kDecodeKeysPerGroup = 2;")],
    "threads256": [("kDecodeThreads = 128;", "kDecodeThreads = 256;")],
    "rows8": [("kDecodeMaxRows = 4;", "kDecodeMaxRows = 8;")],
}
SPLITS = (1, 4, 8, 16)
OUT = ROOT / "build" / "decode_sweep"


def build_variants() -> dict:
    source = (_build.SOURCE_DIR / "paged_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "paged_attention.cu").write_text(text)
        shutil.copy(_build.SOURCE_DIR / "hopper.cuh", d)
        cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-o",
               str(d / "lib.so"), str(d / "paged_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{out}{err}")
        rows = [r for r in chip_smoke.ptxas_summary(out + err)
                if "paged_decode" in r["kernel"]]
        print(json.dumps({"variant": name, "edits": VARIANTS[name],
                          "decode_kernels": len(rows),
                          "spilled": [r for r in rows
                                      if r.get("spill_stores")]}), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tpuhpc_paged_decode.argtypes = [p] * 11 + [i] * 8 + [f, i, i, p]
        lib.tpuhpc_paged_decode.restype = i
        lib.tpuhpc_decode_splits.argtypes = [i] * 4
        lib.tpuhpc_decode_splits.restype = i
        libs[name] = lib
    return libs


def launch(lib, args, kw, n_split):
    """One decode through ``lib`` with ``n_split`` runs."""
    q, k, v, tables, pos, active = args
    slots, hkv, g, d = q.shape
    out = torch.empty_like(q)
    rows = slots * hkv * n_split * g
    ws = torch.empty(rows * (d + 1), dtype=torch.float32, device=q.device)
    parts = (ws.data_ptr(), ws[rows * d:].data_ptr()) if n_split > 1 \
        else (None, None)
    scales = [None if kw.get(s) is None else kw[s].data_ptr()
              for s in ("k_scale", "v_scale")]
    code = lib.tpuhpc_paged_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), active.data_ptr(), *scales, out.data_ptr(), *parts,
        slots, hkv, g, d, kw["block_size"], tables.shape[1],
        kw["max_blocks"], n_split, d ** -0.5, DTYPE_CODES[q.dtype],
        DTYPE_CODES[k.dtype], torch.cuda.current_stream().cuda_stream)
    if code:
        raise SystemExit(f"decode launch failed: CUDA error {code}")
    return out


def device_ms(fn, iters=30) -> dict:
    """Device ms per call of the split and the combine kernels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    res = {"split": 0.0, "combine": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "paged_decode" in e.key:
            part = "combine" if "combine" in e.key else "split"
            res[part] += e.self_device_time_total / 1e3 / iters
    res["total"] = res["split"] + res["combine"]
    return res


def probes(dev) -> None:
    x = torch.empty(64 << 20, dtype=torch.bfloat16, device=dev).normal_()
    for name, fn, reads_writes in (("sum_128MB", x.sum, 1),
                                   ("copy_128MB", x.clone, 2)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 20
        nbytes = x.numel() * x.element_size() * reads_writes
        print(json.dumps({"probe": name, "us": us,
                          "tb_per_s": nbytes / us / 1e6}), flush=True)


def contiguous_case(dev):
    """The 7B decode case's positions and bytes, one head per slot."""
    pos0 = [1023, 517, 64, 15, 300, 811, 0, 700]
    act0 = [1, 1, 1, 1, 1, 1, 0, 1]
    pos = torch.tensor([p for p in pos0 for _ in range(32)],
                       dtype=torch.int32)
    active = torch.tensor([a for a in act0 for _ in range(32)],
                          dtype=torch.int32)
    n_live = [(p // 16 + 1) if a else 0
              for p, a in zip(pos.tolist(), active.tolist())]
    num_blocks = sum(n_live) + 1
    perm = torch.randperm(num_blocks - 1,
                          generator=torch.Generator().manual_seed(0)) + 1
    tables = torch.zeros((256, 96), dtype=torch.int32)
    nxt = 0
    for s, n in enumerate(n_live):
        tables[s, :n] = perm[nxt:nxt + n].to(torch.int32)
        nxt += n
    gen = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn((num_blocks, 16, 1, 128), generator=gen, device=dev)
    v = torch.randn((num_blocks, 16, 1, 128), generator=gen, device=dev)
    q = torch.randn((256, 1, 1, 128), generator=gen, device=dev)
    args = (q.bfloat16(), k.bfloat16(), v.bfloat16(), tables.to(dev),
            pos.to(dev), active.to(dev))
    return args, dict(block_size=16, max_blocks=64)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi_line()}), flush=True)
    chip_smoke.CHIP = chip_for_kind(torch.cuda.get_device_name(0))
    libs = build_variants()
    probes(dev)
    for shape, (hkv, g) in (("7b", (32, 1)), ("gqa", (8, 8))):
        for quant in (False, True):
            args, kw, (nb, fl) = chip_smoke.decode_case(torch, dev, hkv, g,
                                                        quant)
            want = pa.paged_decode_attention_ref(*args, **kw)
            bound_ms, _ = chip_smoke.bound(nb, fl, args[0].dtype)
            for name, lib in libs.items():
                auto = lib.tpuhpc_decode_splits(8, hkv, g, 64)
                for n in sorted({*SPLITS, auto}):
                    readings = compare(launch(lib, args, kw, n), want,
                                       torch.bfloat16)
                    t = device_ms(lambda: launch(lib, args, kw, n))
                    print(json.dumps({
                        "case": shape, "pool": "int8" if quant else "bf16",
                        "variant": name, "n_split": n, "auto": n == auto,
                        "ok": readings["ok"], **t,
                        "bound_share": bound_ms / t["total"]}), flush=True)
            del args, kw, want
            torch.cuda.empty_cache()
    args, kw = contiguous_case(dev)
    for n in (4, 8):
        t = device_ms(lambda: launch(libs["base"], args, kw, n))
        print(json.dumps({"contiguous": "7b bytes, one head per slot",
                          "n_split": n, **t}), flush=True)
    args, kw, _ = chip_smoke.decode_case(torch, dev, 32, 1, False)
    alone = torch.zeros_like(args[5])
    alone[0] = 1
    args = (*args[:5], alone)
    for n in (1, 8):
        t = device_ms(lambda: launch(libs["base"], args, kw, n))
        print(json.dumps({"alone": "7b slot 0: 64 pages", "n_split": n,
                          **t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
