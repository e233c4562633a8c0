#!/usr/bin/env python3
"""The split-TF32 routes on the card: the prefill's float32 and mixed
pairs (``paged_prefill_tf32_kernel``) and the float32 flash forward,
dq and dk/dv (``flash_fwd_tf32_kernel``, ``flash_dq_tf32_kernel``,
``flash_dkv_tf32_kernel``), each held against its plain version.

    python3 docs/port/tf32_routes.py [--time]

Builds the kernel library from ``tpu_hpc_torch/csrc`` (one JSON line
with each TF32 kernel's registers and spills from nvcc's ``-Xptxas
-v``), then, for every pair of the TF32 route, a small ragged prefill
(bs 16, d 64 and 128, groups 1 and 4, a chunk that starts inside a
page) and the 7B chunk of 256 at start 256 (32 heads, d 128, bs 16),
and the float32 forward, dq and dk/dv (from the plain forward's lse
and D) at a small GQA shape and at B 1, S 1000, 8 heads, d 128,
causal, each at kv_offset 0 and 100. Each reading:
``checks/tolerance.py``'s rule for q's dtype and, where P is rounded to
a coarser 16-bit pool's dtype, the pool's (``rule_dtype``), which
gates. ``--time`` adds, at the large shapes, ms (CUDA events over
back-to-back calls), device ms (torch.profiler), the plain version's ms
(flash) and the device ms of one PyTorch call on the same inputs
(scaled_dot_product_attention: its forward, or its autograd backward,
dq, dk and dv together; never called by the port). One JSON line a
case; the last line says whether every gated reading passed.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# (q dtype, pool dtype) pairs the TF32 prefill route takes.
PAIRS = (("float32", "float32"), ("float32", "int8"), ("float32", "bfloat16"),
         ("float32", "float16"), ("bfloat16", "float32"),
         ("float16", "float32"), ("float16", "bfloat16"),
         ("bfloat16", "float16"))


def small_prefill(torch, dev, q_name, pool, *, g, d, bs=16, bucket=40,
                  start=21, hkv=2, seed=0):
    from tpu_hpc_torch.kernels import paged_attention as pa

    gen = torch.Generator(device="cpu").manual_seed(seed)
    ctx = (start + bucket - 1) // bs + 1
    mb, nb = ctx + 2, ctx + 10
    k = torch.randn((nb, bs, hkv, d), generator=gen)
    v = torch.randn((nb, bs, hkv, d), generator=gen)
    k[-1] = v[-1] = float("nan")
    table = torch.full((mb + 2,), nb - 1, dtype=torch.int32)
    table[:ctx] = (torch.randperm(nb - 2, generator=gen)[:ctx] + 1).int()
    scales = {}
    if pool == "int8":
        k, ks = pa.quantize_pages_int8(k)
        v, vs = pa.quantize_pages_int8(v)
        ks[-1] = vs[-1] = float("nan")
        scales = dict(k_scale=ks.to(dev), v_scale=vs.to(dev))
    else:
        k, v = k.to(getattr(torch, pool)), v.to(getattr(torch, pool))
    q = torch.randn((hkv, bucket, g, d), generator=gen).to(getattr(torch, q_name))
    return ((q.to(dev), k.to(dev), v.to(dev), table.to(dev), start),
            dict(block_size=bs, max_blocks=mb, **scales))


def main() -> int:
    import torch

    import chip_smoke
    from tpu_hpc_torch.checks.tolerance import compare, rule_dtype
    from tpu_hpc_torch.kernels import _build
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.kernels import paged_attention as pa

    timed = "--time" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("tf32_routes: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build_s = _build.build()
    rows = [r for r in chip_smoke.ptxas_summary(_build.PTXAS_LOG.read_text())
            if "tf32" in r["kernel"]]
    print(json.dumps({"build_s": build_s, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi_line(),
                      "tf32_kernels": rows}), flush=True)
    ok = True

    def report(case, got, want, q_dtype, gate_dtype, extra):
        nonlocal ok
        torch.cuda.synchronize()
        r = {"case": case, **extra,
             "q_rule": compare(got, want, q_dtype)}
        if gate_dtype != q_dtype:
            r["gate_rule"] = compare(got, want, gate_dtype)
        gate = r.get("gate_rule", r["q_rule"])
        r["ok"] = bool(gate["ok"] and torch.isfinite(got).all())
        ok = ok and r["ok"]
        print(json.dumps(r), flush=True)

    for q_name, pool in PAIRS:
        q_dtype = getattr(torch, q_name)
        gate = rule_dtype(q_dtype, None if pool == "int8" else
                          getattr(torch, pool))
        for d in (64, 128):
            for g in (1, 4):
                args, kw = small_prefill(torch, dev, q_name, pool, g=g, d=d,
                                         seed=d + g)
                route = pa.paged_prefill_route(args[0].dtype, args[1].dtype, d,
                                               kw["block_size"])
                got = pa.paged_prefill_attention(*args, **kw)
                want = pa.paged_prefill_attention_ref(*args, **kw)
                report("prefill_small", got, want, q_dtype, gate,
                       dict(q=q_name, pool=pool, d=d, g=g, route=route))
        args, kw, (nb, fl) = chip_smoke.prefill_case(torch, dev, 32, 1, pool,
                                                     256, q_dtype)
        fn = pa.paged_prefill_attention
        got = fn(*args, **kw)
        want = pa.paged_prefill_attention_ref(*args, **kw)
        extra = dict(q=q_name, pool=pool, shape="7b", start=256,
                     route=pa.paged_prefill_route(args[0].dtype,
                                                  args[1].dtype, 128, 16))
        if timed:
            lib_fn = chip_smoke.library_prefill(torch, args, kw)
            extra.update(
                ms=chip_smoke.time_ms(lambda: fn(*args, **kw), iters=50),
                device_ms=chip_smoke.device_ms(lambda: fn(*args, **kw),
                                               "paged_prefill"),
                library_device_ms=chip_smoke.device_ms(lib_fn, ""),
                bytes=nb, flops=fl)
        report("prefill_7b", got, want, q_dtype, gate, extra)

    for name, b, s, hq, hkv in (("flash_small", 2, 200, 8, 2),
                                ("flash_1f", 1, 1000, 8, 8)):
        gen = torch.Generator(device=dev).manual_seed(7)
        q = torch.randn((b, s, hq, 128), generator=gen, device=dev)
        k = torch.randn((b, s, hkv, 128), generator=gen, device=dev)
        v = torch.randn((b, s, hkv, 128), generator=gen, device=dev)
        for qo, ko in ((0, 0), (0, 100)):
            out, lse = fa.flash_attention_fwd(q, k, v, qo, ko)
            want_o, want_l = fa.flash_attention_fwd_ref(q, k, v, qo, ko)
            live = want_l > fa.MASK_VALUE * 0.5
            extra = dict(b=b, s=s, hq=hq, hkv=hkv, q_offset=qo, kv_offset=ko,
                         lse_max_abs_err=float((lse[live] - want_l[live])
                                               .abs().max()),
                         masked_rows_zero=bool(not out[~live].any()) and bool(
                             (lse[~live] == fa.MASK_VALUE).all()))
            if timed and name == "flash_1f" and ko == 0:
                fn = fa.flash_attention_fwd
                lib_fwd, _ = chip_smoke.library_flash(torch, q, k, v, q, True)
                extra.update(
                    ms=chip_smoke.time_ms(lambda: fn(q, k, v), iters=20),
                    device_ms=chip_smoke.device_ms(lambda: fn(q, k, v),
                                                   "flash_fwd"),
                    library_device_ms=chip_smoke.device_ms(lib_fwd, ""))
            report(name, out, want_o, torch.float32, torch.float32, extra)
            ok = ok and extra["masked_rows_zero"] and \
                extra["lse_max_abs_err"] < 1e-3
            # The backward kernels on the plain forward's lse and D.
            dout = torch.randn(q.shape, generator=gen, device=dev)
            dlse = torch.randn(want_l.shape, generator=gen, device=dev)
            dm = (dout * want_o).sum(-1) - dlse
            bargs = (q, k, v, dout, want_l, dm, qo, ko)
            for kname, fn, ref, outs in (
                    ("dq", fa.flash_attention_dq, fa.flash_attention_dq_ref,
                     ("dq",)),
                    ("dkv", fa.flash_attention_dkv,
                     fa.flash_attention_dkv_ref, ("dk", "dv"))):
                got = fn(*bargs)
                want = ref(*bargs)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                extra = dict(b=b, s=s, hq=hq, hkv=hkv, q_offset=qo,
                             kv_offset=ko)
                if timed and name == "flash_1f" and ko == 0:
                    _, lib_bwd = chip_smoke.library_flash(torch, q, k, v,
                                                          dout, True)
                    extra.update(
                        ms=chip_smoke.time_ms(lambda: fn(*bargs), iters=20),
                        device_ms=chip_smoke.device_ms(
                            lambda: fn(*bargs), f"flash_{kname}"),
                        plain_ms=chip_smoke.time_ms(lambda: ref(*bargs),
                                                    iters=3, warmup=1),
                        library_device_ms=chip_smoke.device_ms(lib_bwd, ""))
                for part, g_, w_ in zip(outs, got, want):
                    report(f"{name}_{part}", g_, w_, torch.float32,
                           torch.float32, extra)
    print(json.dumps({"ok": ok, "seconds": time.perf_counter() - t0}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
