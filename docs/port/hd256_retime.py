#!/usr/bin/env python3
"""Times the flash and TF32 prefill kernels of several checkouts in one
call: the head_dim-256 redesigns beside the rows they must not move.

Cases (``CASES``, PERF.md's rows): the forward and dq at Gemma-2B's
training attention (1G, 2G: B 1, S 2048, 8 query heads over 1 KV head of
256, causal, bf16), at the training shape (1, 2), at head_dim 72 (1e,
2e) and at the ViT's shape (1v, 2v); the prefill at Gemma's attention
over bf16 pages (5G, its walk shared with the forward); dk/dv at the training shape (3: B 4,
S 2048, 8 heads, head_dim 128, causal, bf16), at head_dim 72 (3e,
padded to 128), at the ViT's shape (3v: B 8, S 512, head_dim 32, no
mask) and at Gemma-2B's training attention (3G: B 1, S 2048, 8 query
heads over 1 KV head of 256, causal, bf16); the float32 flash forward
at chip_smoke.py's float32 case (1f: B 1, S 1000, 8 heads, head_dim 128;
it runs the TF32 walk the prefill runs); and the prefill's TF32 route
at the 7B chunk of 256 at start 256 over float32 (5s: 16-token pages;
5p: 12-token pages; 5d: head_dim 72) and at Gemma-2B's attention (1 KV
head, group 8, head_dim 256, the same chunk) over float32 (5S) and under
a float32 q over bf16, a float32 q over int8 and a bf16 q over float32.
The dk/dv at the kD 128 GQA shapes chip_smoke.py launches, whose groups
the split rule (``attention.dkv_splits``) spreads over blocks: its
70B-like dims (B 1, S 2048, 64 query heads over 8), its ragged GQA
tiles (B 2, S 1100, 16 over 2, queries at offset 300) and the
sequence-parallel GQA shape's pairs (B 2, 16 over 2): the ring's
512-token shards at degree 4 (rank 3's chunk against rank 0's, and a
rank's own chunk) and zigzag's 256-token chunks (chunk 7 against chunk
3, and its own), and Ulysses' call a rank (B 2, S 2048, 4 query heads
over the 4 its KV heads are repeated to: a group of 1, never split). With
``--dkv-splits 1,2,4,8`` a root whose ``flash_attention_dkv`` takes
``n_split=`` also times each dk/dv case of a grouped shape at each of
those splits that divides its group (``<case>_split_<n>``); with
``--cases 3G,gqa_70b,...`` only the cases named run (and their splits);
with ``--clusters 1,2,4,8`` a root whose forward and dq take
``cluster=`` also times each of their cases past head_dim 128 at each of
those cluster sizes that divides its group (``<case>_cluster_<n>``; the
case itself runs the rule's, ``gqa_cluster`` in its reading).

Each checkout builds its own library (``<root>/build``) and is timed in
its own process, in turns A, B, ..., B, A, so a drift of the card over
the call reads as a drift and not as a difference:

    python3 docs/port/hd256_retime.py [--dkv-splits 1,2,4,8] [--cases A,B]
        [--clusters 1,2,4,8] ROOT_A ROOT_B [...]

where each root holds a ``tpu_hpc_torch`` package (e.g. an older
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists); the inputs, bounds and SDPA yardsticks come from this
checkout's ``chip_smoke.py``. Per case: ``ms`` (CUDA events over
back-to-back calls, wrapper included), ``device_ms`` (torch.profiler:
the kernels whose names hold ``flash_dkv`` -- the split dk/dv's sum
pass included -- ``flash_fwd`` or ``paged_prefill``), the largest error
against the plain version and whether ``checks/tolerance.py``'s rule
holds, the route (prefill), the bound and SDPA's time (3G: its autograd
backward, dq, dk and dv together; the prefill: over the gathered pages)
in the first root's first turn; the forward's out and dq's crc32 (their
bits, to compare across roots). One JSON line per reading (with
``nvidia-smi``'s name and power limit), then a summary line with each
root's device ms per case.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Flash: (name, kernel, b, s, hq, hkv, d, causal, q_offset, kv_offset,
# dtype)
FLASH = (
    ("1G", "fwd", 1, 2048, 8, 1, 256, True, 0, 0, "bfloat16"),
    ("2G", "dq", 1, 2048, 8, 1, 256, True, 0, 0, "bfloat16"),
    ("1", "fwd", 4, 2048, 8, 8, 128, True, 0, 0, "bfloat16"),
    ("2", "dq", 4, 2048, 8, 8, 128, True, 0, 0, "bfloat16"),
    ("1e", "fwd", 4, 2048, 8, 8, 72, True, 0, 0, "bfloat16"),
    ("2e", "dq", 4, 2048, 8, 8, 72, True, 0, 0, "bfloat16"),
    ("1v", "fwd", 8, 512, 8, 8, 32, False, 0, 0, "bfloat16"),
    ("2v", "dq", 8, 512, 8, 8, 32, False, 0, 0, "bfloat16"),
    ("3", "dkv", 4, 2048, 8, 8, 128, True, 0, 0, "bfloat16"),
    ("3e", "dkv", 4, 2048, 8, 8, 72, True, 0, 0, "bfloat16"),
    ("3v", "dkv", 8, 512, 8, 8, 32, False, 0, 0, "bfloat16"),
    ("3G", "dkv", 1, 2048, 8, 1, 256, True, 0, 0, "bfloat16"),
    ("1f", "fwd", 1, 1000, 8, 8, 128, True, 0, 0, "float32"),
    ("gqa_70b", "dkv", 1, 2048, 64, 8, 128, True, 0, 0, "bfloat16"),
    ("gqa_ragged", "dkv", 2, 1100, 16, 2, 128, True, 300, 0, "bfloat16"),
    ("sp_gqa_ring_past", "dkv", 2, 512, 16, 2, 128, True, 1536, 0,
     "bfloat16"),
    ("sp_gqa_ring_own", "dkv", 2, 512, 16, 2, 128, True, 512, 512,
     "bfloat16"),
    ("sp_gqa_zigzag_past", "dkv", 2, 256, 16, 2, 128, True, 1792, 768,
     "bfloat16"),
    ("sp_gqa_zigzag_own", "dkv", 2, 256, 16, 2, 128, True, 1792, 1792,
     "bfloat16"),
    ("sp_gqa_ulysses", "dkv", 2, 2048, 4, 4, 128, True, 0, 0, "bfloat16"),
)
# Prefill: (name, (kv heads, group), pool, q dtype, page tokens, head_dim)
PREFILL = (
    ("5G", (1, 8), "bfloat16", "bfloat16", 16, 256),
    ("5s", (32, 1), "float32", "float32", 16, 128),
    ("5p", (32, 1), "float32", "float32", 12, 128),
    ("5d", (32, 1), "float32", "float32", 16, 72),
    ("5S", (1, 8), "float32", "float32", 16, 256),
    ("5S_f32_over_bf16", (1, 8), "bfloat16", "float32", 16, 256),
    ("5S_f32_over_int8", (1, 8), "int8", "float32", 16, 256),
    ("5S_bf16_over_f32", (1, 8), "float32", "bfloat16", 16, 256),
)

CHILD = r"""
import importlib.util, inspect, json, sys, zlib
sys.path.insert(0, sys.argv[1])
FIRST = sys.argv[2] == "1"
import torch
# This checkout's chip_smoke (its cases and bounds), the root's kernels.
spec = importlib.util.spec_from_file_location(
    "chip_smoke", REPO + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from tpu_hpc_torch.checks.roofline import chip_for_kind
from tpu_hpc_torch.checks.tolerance import compare, rule_dtype
from tpu_hpc_torch.kernels import _build
from tpu_hpc_torch.kernels import attention as fa
from tpu_hpc_torch.kernels import paged_attention as pa

build_s = _build.build()
lib = _build.load_library()
dev = torch.device("cuda", 0)
cs.CHIP = chip_for_kind(torch.cuda.get_device_name(0))
ptxas = [r for r in cs.ptxas_summary(_build.PTXAS_LOG.read_text())
         if ("256" in r["kernel"] and "flash" in r["kernel"])
         or "tf32_kernel<f32, f32, 256" in r["kernel"]
         or "dkv_sum" in r["kernel"] or "gqa" in r["kernel"]]
row = {"root": sys.argv[1], "build_s": build_s, "ptxas": ptxas,
       "nvidia_smi": cs.nvidia_smi_line()}
splits = "n_split" in inspect.signature(fa.flash_attention_dkv).parameters
share = hasattr(fa, "gqa_cluster")
cases = []
for c in FLASH:
    if ONLY and c[0] not in ONLY:
        continue
    cases.append(c + (None,))
    g = c[4] // c[5]
    if splits and c[1] == "dkv":
        cases += [("%s_split_%d" % (c[0], n),) + c[1:] + (n,)
                  for n in DKV_SPLITS if g % n == 0 and g > 1]
    if share and c[1] in ("fwd", "dq") and c[6] > 128:
        cases += [("%s_cluster_%d" % (c[0], n),) + c[1:] + (n,)
                  for n in CLUSTERS if g % n == 0]


def timed(r, fn, kname):
    r.update(ms=cs.time_ms(fn, iters=20),
             device_ms=cs.device_ms(fn, kname))


for name, kernel, b, s, hq, hkv, d, causal, qo, ko, dt, n_split in cases:
    dtype = getattr(torch, dt)
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    dout = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
    case = (name, b, s, s, hq, hkv, d, causal, qo, ko, dt, True)
    nb, fl = cs.flash_work(case)["flash_attention_" + kernel]
    r, ck = {}, {}
    if share and kernel in ("fwd", "dq"):  # where the root has the rule
        # n_split names the case's cluster here (None: the rule's).
        r["gqa_cluster"] = fa._cluster("flash_attention_" + kernel, q, k,
                                       n_split)
        ck["cluster"] = r["gqa_cluster"]
    if kernel == "fwd":
        fn = lambda: fa.flash_attention_fwd(q, k, v, **kw, **ck)
        got, want = fn()[0], fa.flash_attention_fwd_ref(q, k, v, **kw)[0]
        c = [compare(got, want, dtype)]
        r["crc32"] = zlib.crc32(
            got.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        if dtype == torch.float32:
            r["bound_ms"], r["bound_by"] = cs.bound_tf32(nb, fl, dt, dt)
        else:
            r["bound_ms"], r["bound_by"] = cs.bound(nb, fl, dtype)
        timed(r, fn, "flash_fwd")
        if FIRST and name == "1G":  # the library once, at the rule's case
            fwd = cs.library_flash(torch, q, k, v, dout, causal)[0]
            r.update(library_ms=cs.time_ms(fwd, iters=20),
                     library_device_ms=cs.device_ms(fwd, ""),
                     library="sdpa forward")
    elif kernel == "dq":
        # chip_smoke.py's flash case: D less a random dlse.
        dlse = torch.randn((b, s, hq), generator=gen, device=dev)
        o, lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
        dm = (dout.float() * o.float()).sum(-1) - dlse
        bargs = (q, k, v, dout, lse, dm)
        fn = lambda: fa.flash_attention_dq(*bargs, **kw, **ck)
        got = fn()
        again = fn()
        torch.cuda.synchronize()
        want = fa.flash_attention_dq_ref(*bargs, **kw)
        c = [compare(got, want, dtype)]
        r["bit_identical"] = bool(torch.equal(got, again))
        r["crc32"] = zlib.crc32(
            got.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        r["bound_ms"], r["bound_by"] = cs.bound(nb, fl, dtype)
        timed(r, fn, "flash_dq")
        del o, lse, dm, bargs, got, again
    else:
        o, lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
        dm = (dout.float() * o.float()).sum(-1)
        bargs = (q, k, v, dout, lse, dm)
        extra = {} if n_split is None else {"n_split": n_split}
        fn = lambda: fa.flash_attention_dkv(*bargs, **kw, **extra)
        got = fn()
        again = fn()
        torch.cuda.synchronize()
        want = fa.flash_attention_dkv_ref(*bargs, **kw)
        c = [compare(a, w, dtype) for a, w in zip(got, want)]
        r["bit_identical"] = all(torch.equal(a, x) for a, x in zip(got, again))
        r["bound_ms"], r["bound_by"] = cs.bound(nb, fl, dtype)
        if splits:
            r["n_split"] = n_split or fa.dkv_splits(
                b, s, hq, hkv, d, dtype,
                torch.cuda.get_device_properties(dev).multi_processor_count)
        timed(r, fn, "flash_dkv")
        if FIRST and name == "3G":
            bwd = cs.library_flash(torch, q, k, v, dout, causal)[1]
            r.update(library_ms=cs.time_ms(bwd, iters=20),
                     library_device_ms=cs.device_ms(bwd, ""),
                     library="sdpa autograd backward (dq, dk, dv together)")
        del o, lse, dm, bargs, got, again
    r.update(max_abs_err=max(x["max_abs_err"] for x in c),
             rule_ok=all(x["ok"] for x in c), bytes=nb, flops=fl)
    row[name] = r
    del q, k, v, dout, want
    torch.cuda.empty_cache()

for name, (hkv, g), pool, q_name, bs, d in PREFILL:
    if ONLY and name not in ONLY:
        continue
    q_dtype = getattr(torch, q_name)
    args, kw, (nb, fl) = cs.prefill_case(torch, dev, hkv, g, pool, 256,
                                         q_dtype, bs=bs, d=d)
    fn = lambda: pa.paged_prefill_attention(*args, **kw)
    r = {"route": pa.PREFILL_ROUTES[lib.tpuhpc_prefill_route(
        d, bs, pa.DTYPE_CODES[q_dtype], pa.DTYPE_CODES[args[1].dtype])]}
    out = fn()
    torch.cuda.synchronize()
    want = pa.paged_prefill_attention_ref(*args, **kw)
    gate = rule_dtype(q_dtype, None if pool == "int8" else args[1].dtype)
    c = compare(out, want, gate)
    r.update(max_abs_err=c["max_abs_err"], rule_ok=c["ok"], bytes=nb,
             flops=fl)
    if r["route"] == "wgmma_tf32":
        r["bound_ms"], r["bound_by"] = cs.bound_tf32(nb, fl, q_name, pool)
    else:
        r["bound_ms"], r["bound_by"] = cs.bound(nb, fl, q_dtype)
    r["bound_fp32_fma_ms"] = cs.bound(nb, fl, torch.float32)[0]
    timed(r, fn, "paged_prefill")
    if FIRST and name.startswith("5S"):
        lib_call = cs.library_prefill(torch, args, kw)
        r.update(library_ms=cs.time_ms(lib_call, iters=50),
                 library_device_ms=cs.device_ms(lib_call, ""))
    row[name] = r
    del args, kw, out, want
    torch.cuda.empty_cache()
print(json.dumps(row))
"""


def main(argv) -> int:
    splits, only, clusters = (), (), ()
    while argv[:1] in (["--dkv-splits"], ["--cases"], ["--clusters"]):
        if argv[0] == "--dkv-splits":
            splits = tuple(int(x) for x in argv[1].split(","))
        elif argv[0] == "--clusters":
            clusters = tuple(int(x) for x in argv[1].split(","))
        else:
            only = tuple(argv[1].split(","))
        argv = argv[2:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in argv]
    code = (f"REPO = {REPO!r}\nFLASH = {FLASH!r}\nPREFILL = {PREFILL!r}\n"
            f"DKV_SPLITS = {splits!r}\nCLUSTERS = {clusters!r}\n"
            f"ONLY = {only!r}\n" + CHILD)
    readings = []
    for i, root in enumerate(roots + roots[::-1]):
        out = subprocess.run([sys.executable, "-c", code, root,
                              "1" if i == 0 else "0"],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        readings.append(row)
    summary = {}
    for root in roots:
        rows = [r for r in readings if r["root"] == root]
        summary[root] = {
            name: [r[name].get("device_ms") for r in rows]
            for name in rows[0] if isinstance(rows[0][name], dict)}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
