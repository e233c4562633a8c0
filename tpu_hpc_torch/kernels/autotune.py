"""Flash-attention and paged-decode autotuner: measure, don't guess.

Port of the JAX package's ``kernels/autotune.py``. There the Pallas
kernels' VMEM tiling (block_q, block_k) is swept; here the sweep is what
the Hopper kernels can vary without a new layout:

* ``mode="fwd"`` / ``"grad"`` (the three flash kernels): the forward's
  K/V ring depth ``kFwdStages`` (``csrc/flash_attention.cu``), a
  compile-time constant. Each candidate is that source built with
  ``-DTPUHPC_FWD_STAGES=n`` into its own library under
  ``build/tpu_hpc_torch/autotune/<candidate>/``
  (``_build.build_variants``), all builds started together; the library
  the main path loads is the ``kFwdStages=4`` row. The source's
  static_asserts hold the ring to the shared-memory budget, so a depth
  they reject is a record that says "refused" with nvcc's reason --
  never dropped. The backward has no such constant: its streamed-tile
  step ``kBwdStep`` is the wgmma m64n64 score tile itself (a
  static_assert pins it to 64), so ``sweep_bwd=True`` adds one record,
  refused for that layout reason with the forward pinned to the best
  forward candidate, and builds nothing. The row/warpgroup layout
  (``FwdShape``: 128 rows = two consumer warpgroups x 64, one warpgroup
  at head_dim 256, whose ring takes at most three stages) is not a
  candidate.
* ``mode="decode"`` (the paged decode): the run count ``n_split`` the C
  entry takes at runtime, over ``DECODE_SPLITS`` and "auto" (the
  library's pick), at ``chip_smoke.py``'s 7B decode shape (8 slots, 32
  KV heads, 16-token pages, 64-page views).

Timing: a chain of ``iters`` links after a warm one, each link's
output the next one's input; a ``grad`` link launches the forward, dq
and dk/dv, so no backward kernel goes untimed (the JAX module's rule).
Only the candidate's kernels run in a link. On a card the ranked time
is the chain captured once in a CUDA graph and replayed, timed with
CUDA events: the device's time for the kernels without the host's
launches, which bound the eager ``grad`` and ``decode`` chains. CUDA
events around the eager chain give the wall time beside it. Correctness: every
candidate's outputs are held against the plain versions (``*_ref``)
under ``checks/tolerance.py`` before it is ranked; a candidate that is
fast and wrong raises.

The tuner only reports: like the JAX autotuner it does not feed its pick
back, and the main path's launches keep the default build's constants
and the library's ``n_split``. On CPU tensors (``device="cpu"``) every
candidate runs the plain versions, which ignore the tile constants and
honour ``n_split``; no library is built.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpu_hpc_torch.kernels import attention as fa
from tpu_hpc_torch.kernels import paged_attention as pa

MODES = ("fwd", "grad", "decode")
# kFwdStages candidates; 4 is the default build's. 8 is past the shared
# memory budget at head_dim 128 (the static_assert refuses it).
FWD_STAGES: Tuple[int, ...] = (2, 3, 4, 5, 6, 8)
DEFAULT_FWD_STAGES = 4
# The step --sweep-bwd asks for; csrc/flash_attention.cu's static_assert
# pins kBwdStep to 64, the wgmma n64 shape, with this reason.
SWEPT_BWD_STEP = 32
BWD_STEP_LAYOUT = ("kBwdStep: the backward's score tiles are wgmma m64n64 "
                   "(wgmma_ss_n64); a step other than 64 needs a new layout")
DECODE_SPLITS: Tuple[int, ...] = (1, 2, 4, 8, 16)
# Replays of a candidate's captured chain that its time is the mean of.
REPLAYS = 5
# Keys per streamed K/V tile of the forward (hopper.cuh kWalkKeys).
WALK_KEYS = 64
LSE_ATOL = 1e-3

# chip_smoke.py's 7B decode shape: 8 slots over a 513-page pool of
# 16-token pages, 64-page views in 96-wide table rows, slot 6 inactive.
DECODE_POS = (1023, 517, 64, 15, 300, 811, 0, 700)
DECODE_ACTIVE = (1, 1, 1, 1, 1, 1, 0, 1)


@dataclasses.dataclass
class TuneRecord:
    """One candidate: its constants (``defines``: the -D overrides; for
    decode ``{"n_split": n}``), time per call (on a card the chain's
    CUDA-graph replay; None when refused), its largest error against the plain
    version, whether it is what the default build or the library picks,
    and the wall time per call around the chain (cards only)."""

    candidate: str
    mode: str  # "fwd" | "grad" | "decode"
    ms_per_call: Optional[float]
    defines: Dict[str, int]
    max_abs_err: Optional[float] = None
    library_pick: bool = False
    refused: Optional[str] = None  # nvcc's reason, or the layout's
    wall_ms: Optional[float] = None

    def blocks(self) -> str:
        """The candidate's label (the JAX record's name for it)."""
        return self.candidate + (" (library)" if self.library_pick else "")

    def reason(self) -> Optional[str]:
        """A refused candidate's compiler error line (the static_assert
        that rejected it), else nvcc's last line; None when it ran."""
        if self.refused is None:
            return None
        lines = [ln.strip() for ln in self.refused.splitlines() if ln.strip()]
        return next((ln for ln in lines if "error" in ln and "(" in ln),
                    lines[-1] if lines else "")


def _sort(records: List[TuneRecord]) -> List[TuneRecord]:
    """Fastest first; refused candidates last, in their given order."""
    return sorted(records, key=lambda r: (r.ms_per_call is None,
                                          r.ms_per_call or 0.0))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_chain(step: Callable, x,
                iters: int) -> Tuple[float, Optional[float]]:
    """(ms per call, wall ms per call) of ``iters`` dependent
    applications of ``step`` after a warm one. On a card the first is
    the chain captured in a CUDA graph, its mean over ``REPLAYS``
    replays after a warm one (CUDA events), and the wall time is CUDA
    events around the eager chain; on the CPU the host clock and
    None."""
    from tpu_hpc_torch.checks.env_check import time_loop

    wall = time_loop(iters, step, x) / iters * 1e3
    if x.device.type != "cuda":
        return wall, None
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        step(x)  # the capture's warm-up, on its own stream
    torch.cuda.current_stream(x.device).wait_stream(side)
    with torch.cuda.graph(graph):
        y = x
        for _ in range(iters):
            y = step(y)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (REPLAYS * iters)
    del graph  # its pool goes back to the allocator
    return ms, wall


def _check(name: str, readings: List[dict]) -> float:
    """The largest error of a candidate's readings; raises when any is
    outside the tolerance rule."""
    bad = [r for r in readings if not r["ok"]]
    if bad:
        raise RuntimeError(
            f"autotune candidate {name} disagrees with the plain version: "
            f"{bad[0]}")
    return max(r["max_abs_err"] for r in readings)


# -- flash (fwd / grad) ----------------------------------------------------

def _flash_inputs(batch, seq_len, n_heads, kv_heads, head_dim, dtype,
                  device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(h):
        return torch.randn((batch, seq_len, h, head_dim), generator=gen,
                           device=device, dtype=torch.float32).to(dtype)

    return rand(n_heads), rand(kv_heads), rand(kv_heads)


def _flash_want(q, k, v, causal: bool, mode: str) -> Dict[str, torch.Tensor]:
    """The plain versions on (q, k, v), once for every candidate: out and
    lse, and for ``grad`` a dO, the row term dm and dq, dk, dv."""
    out, lse = fa.flash_attention_fwd_ref(q, k, v, 0, 0, causal=causal)
    want = {"out": out, "lse": lse}
    if mode == "grad":
        gen = torch.Generator(device=q.device).manual_seed(1)
        dout = torch.randn(q.shape, generator=gen, device=q.device,
                           dtype=torch.float32).to(q.dtype)
        # A random dlse, as chip_smoke.py's flash cases take: without
        # it dS of a row that sees one key is exactly zero, and so is
        # the first row of dq.
        dlse = torch.randn(lse.shape, generator=gen, device=q.device)
        dm = ((dout.float() * out.float()).sum(-1) - dlse).contiguous()
        dk, dv = fa.flash_attention_dkv_ref(q, k, v, dout, lse, dm, 0, 0,
                                            causal=causal)
        want.update(dout=dout, dm=dm, dk=dk, dv=dv,
                    dq=fa.flash_attention_dq_ref(q, k, v, dout, lse, dm, 0,
                                                 0, causal=causal))
    return want


def _flash_readings(q, k, v, causal: bool, mode: str,
                    want: Dict[str, torch.Tensor]) -> List[dict]:
    """The candidate's kernels against the plain versions (``want``) on
    (q, k, v): the forward's out and lse, and for ``grad`` dq, dk and dv
    from the same dO."""
    from tpu_hpc_torch.checks.tolerance import compare

    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    # The lse is held to chip_smoke.py's flash rule: 1e-3 absolute.
    lse_err = float((lse - want["lse"]).abs().max())
    readings = [compare(out, want["out"], q.dtype),
                {"max_abs_err": lse_err, "ok": lse_err <= LSE_ATOL}]
    if mode == "grad":
        args = (q, k, v, want["dout"], want["lse"], want["dm"])
        dq = fa.flash_attention_dq(*args, causal=causal)
        dk, dv = fa.flash_attention_dkv(*args, causal=causal)
        readings += [compare(dq, want["dq"], q.dtype),
                     compare(dk, want["dk"], q.dtype),
                     compare(dv, want["dv"], q.dtype)]
    _sync(q.device)
    return readings


def _flash_step(k, v, causal: bool, mode: str,
                want: Dict[str, torch.Tensor]) -> Callable:
    """One link of the timed chain: the forward, whose output is the next
    link's q, and for ``grad`` dq and dk/dv at that q (``want``'s dO and
    row term, the forward's lse). Only the candidate's kernels run; one
    stream orders them, and PyTorch drops no launch whose output is
    unread, so every backward kernel is timed."""
    def step(x):
        out, lse = fa.flash_attention_fwd(x, k, v, causal=causal)
        if mode == "grad":
            args = (x, k, v, want["dout"], lse, want["dm"])
            fa.flash_attention_dq(*args, causal=causal)
            fa.flash_attention_dkv(*args, causal=causal)
        return out
    return step


def _flash_candidates(stages: Sequence[int], seq_len: int) -> List[int]:
    """Ring depths that fit the shape: a ring deeper than the K/V tiles
    of the sequence holds nothing more."""
    tiles = -(-seq_len // WALK_KEYS)
    return [s for s in stages if s <= tiles]


def _run_flash(name, defines, lib_path, q, k, v, want, causal, mode, iters,
               library_pick) -> TuneRecord:
    """Time and check one flash candidate (``lib_path`` None: the default
    library, or the plain versions on the CPU)."""
    import contextlib

    from tpu_hpc_torch.kernels import _build

    ctx = contextlib.nullcontext()
    if lib_path is not None:
        ctx = _build.use_library(_build.load_variant(lib_path))
    with ctx:
        err = _check(name, _flash_readings(q, k, v, causal, mode, want))
        step = _flash_step(k, v, causal, mode, want)
        ms, wall = _time_chain(step, q, iters)
    print(f"  {name}: {ms:.4f} ms/call", file=sys.stderr)
    return TuneRecord(name, mode, ms, defines, err, library_pick,
                      wall_ms=wall)


def _build_flash(variants: Dict[str, Dict[str, int]],
                 device: torch.device) -> Dict[str, object]:
    """name -> library path, or the nvcc error; nothing is built for the
    default constants (the main path's library) or on the CPU."""
    if device.type != "cuda":
        return {name: None for name in variants}
    from tpu_hpc_torch.kernels import _build

    todo = {n: d for n, d in variants.items()
            if d["TPUHPC_FWD_STAGES"] != DEFAULT_FWD_STAGES}
    built = _build.build_variants(todo) if todo else {}
    return {n: built.get(n) for n in variants}


def _flash_name(defines: Dict[str, int]) -> str:
    return f"kFwdStages={defines['TPUHPC_FWD_STAGES']}"


def _autotune_flash(q, k, v, *, causal, mode, stages, sweep_bwd, iters,
                    seq_len) -> List[TuneRecord]:
    usable = _flash_candidates(stages, seq_len)
    if not usable:
        raise ValueError(
            f"no candidate fits seq_len {seq_len}: rings of "
            f"{sorted(set(stages))} stages are deeper than its "
            f"{-(-seq_len // WALK_KEYS)} {WALK_KEYS}-key tile(s) -- pass "
            "shallower candidates")
    variants = {_flash_name({"TPUHPC_FWD_STAGES": s}):
                {"TPUHPC_FWD_STAGES": s} for s in usable}
    built = _build_flash(variants, q.device)
    want = _flash_want(q, k, v, causal, mode)
    records = []
    for name, defines in variants.items():
        lib = built[name]
        if isinstance(lib, Exception):
            records.append(TuneRecord(name, mode, None, defines,
                                      refused=str(lib)))
            print(f"  {name}: refused", file=sys.stderr)
            continue
        records.append(_run_flash(
            name, defines, lib, q, k, v, want, causal, mode, iters,
            defines["TPUHPC_FWD_STAGES"] == DEFAULT_FWD_STAGES))
    records = _sort(records)
    if sweep_bwd and mode == "grad" and records[0].ms_per_call is not None:
        # kBwdStep 64 is every forward row's own; no build takes another.
        d = {"TPUHPC_FWD_STAGES": records[0].defines["TPUHPC_FWD_STAGES"]}
        name = f"{_flash_name(d)} kBwdStep={SWEPT_BWD_STEP}"
        records.append(TuneRecord(name, mode, None, d,
                                  refused=BWD_STEP_LAYOUT))
        print(f"  {name}: refused (layout)", file=sys.stderr)
    return records


# -- paged decode ----------------------------------------------------------

def decode_case(device, seed: int = 0, kv_heads: int = 32, group: int = 1,
                head_dim: int = 128):
    """chip_smoke.py's 7B decode shape (``DECODE_POS`` positions, one
    inactive slot): the wrapper's positional and keyword arguments."""
    slots, bs, mb, width, num_blocks = 8, 16, 64, 96, 513
    gen = torch.Generator(device=device).manual_seed(seed)
    perm = (torch.randperm(num_blocks - 1, generator=torch.Generator()
                           .manual_seed(seed)) + 1).tolist()
    tables = torch.tensor(
        [perm[(s * width) % (num_blocks - 1 - width):][:width]
         for s in range(slots)], dtype=torch.int32)
    shape = (num_blocks, bs, kv_heads, head_dim)
    k = torch.randn(shape, generator=gen, device=device).bfloat16()
    v = torch.randn(shape, generator=gen, device=device).bfloat16()
    q = torch.randn((slots, kv_heads, group, head_dim), generator=gen,
                    device=device).bfloat16()
    args = (q, k, v, tables.to(device),
            torch.tensor(DECODE_POS, dtype=torch.int32, device=device),
            torch.tensor(DECODE_ACTIVE, dtype=torch.int32, device=device))
    return args, dict(block_size=bs, max_blocks=mb)


def _autotune_decode(splits, iters, device, seed,
                     case=None) -> List[TuneRecord]:
    from tpu_hpc_torch.checks.tolerance import compare

    args, kw = case if case is not None else decode_case(device, seed)
    q = args[0]
    usable = [n for n in splits if n <= kw["max_blocks"]]
    if not usable:
        raise ValueError(
            f"no candidate fits max_blocks {kw['max_blocks']}: n_split "
            f"{sorted(set(splits))} all exceed it -- pass smaller candidates")
    want = pa.paged_decode_attention_ref(*args, **kw)
    auto = (pa.paged_decode_splits(q.shape[0], q.shape[1], q.shape[2],
                                   kw["max_blocks"])
            if device.type == "cuda" else None)
    records = []
    for n in [*usable, None]:
        name = (f"n_split={n}" if n is not None else
                f"auto (n_split={auto})" if auto is not None else "auto")
        out = pa.paged_decode_attention(*args, n_split=n, **kw)
        _sync(device)
        err = _check(name, [compare(out, want, q.dtype)])
        rest = args[1:]

        def step(x, n=n):
            return pa.paged_decode_attention(x, *rest, n_split=n, **kw)

        ms, wall = _time_chain(step, q, iters)
        print(f"  {name}: {ms:.4f} ms/call", file=sys.stderr)
        records.append(TuneRecord(
            name, "decode", ms, {"n_split": n if n is not None else
                                 (auto or 0)}, err,
            library_pick=n is None, wall_ms=wall))
    return _sort(records)


def autotune(
    seq_len: int = 2048,
    batch: int = 4,
    n_heads: int = 8,
    kv_heads: Optional[int] = None,
    head_dim: int = 128,
    causal: bool = True,
    mode: str = "grad",
    candidates: Optional[Sequence[int]] = None,
    sweep_bwd: bool = False,
    iters: int = 64,
    device: str = "cuda",
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    decode_kv_heads: int = 32,
) -> List[TuneRecord]:
    """Time every candidate at the given shape and return records sorted
    fastest-first (refused candidates last).

    ``mode="grad"`` times the forward, dq and dk/dv kernels together
    (what a training step launches); ``"fwd"`` the forward alone;
    ``"decode"`` the paged decode at the 7B decode shape (the flash shape
    arguments are unused; ``decode_kv_heads`` shrinks it for a CPU
    rehearsal). ``candidates``: ring depths (fwd, grad) or run
    counts (decode); default ``FWD_STAGES`` / ``DECODE_SPLITS``.
    ``sweep_bwd=True`` (grad only) adds the ``kBwdStep`` record, refused
    by the layout, with the forward pinned to the best forward
    candidate."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} ({'|'.join(MODES)})")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("autotune: no CUDA device (pass device='cpu' to "
                           "run the plain versions)")
    if sweep_bwd and mode != "grad":
        print(
            "autotune: --sweep-bwd only applies to mode='grad' "
            "(forward and decode run no backward kernel); ignoring it",
            file=sys.stderr,
        )
    if mode == "decode":
        return _autotune_decode(
            candidates or DECODE_SPLITS, iters, dev, seed,
            decode_case(dev, seed, kv_heads=decode_kv_heads))
    q, k, v = _flash_inputs(batch, seq_len, n_heads, kv_heads or n_heads,
                            head_dim, dtype, dev, seed)
    return _autotune_flash(q, k, v, causal=causal, mode=mode,
                           stages=candidates or FWD_STAGES,
                           sweep_bwd=sweep_bwd, iters=iters, seq_len=seq_len)


def to_markdown(
    records: Sequence[TuneRecord], *, seq_len: int, batch: int,
    n_heads: int, kv_heads: int, head_dim: int, device_kind: str,
) -> str:
    mode = records[0].mode
    shape = ("7B decode: 8 slots x 32 KV heads, 16-token pages, 64-page "
             "views" if mode == "decode" else
             f"B{batch} S{seq_len} H{n_heads}/{kv_heads} D{head_dim}")
    lines = [
        f"# Hopper-kernel autotune -- {device_kind}, {shape} ({mode})",
        "",
        "| candidate | ms/call | wall ms/call | vs best | max abs err |",
        "|---|---|---|---|---|",
    ]
    timed = [r for r in records if r.ms_per_call is not None]
    best = timed[0].ms_per_call if timed else None
    for r in records:
        if r.ms_per_call is None:
            why = r.reason().replace("|", "/")[:160]
            lines.append(f"| {r.blocks()} | refused | -- | -- | {why} |")
            continue
        wall = f"{r.wall_ms:.4f}" if r.wall_ms is not None else "--"
        lines.append(
            f"| {r.blocks()} | {r.ms_per_call:.4f} | {wall} | "
            f"{r.ms_per_call / best:.3f}x | {r.max_abs_err:.3g} |")
    lines += ["", "ms/call: the chain replayed as a CUDA graph on a card "
              "(no host launches), the host clock on the CPU; wall: CUDA "
              "events around the eager chain, host launches included.", ""]
    if timed:
        lines.append(f"Best: **{timed[0].blocks()}** at "
                     f"{timed[0].ms_per_call:.3f} ms/call.")
    else:
        lines.append("Best: none -- every candidate was refused.")
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=None)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--mode", choices=MODES, default="grad")
    p.add_argument("--sweep-bwd", action="store_true",
                   help="also record the backward's kBwdStep, refused by "
                   "its wgmma layout, with the forward pinned to its best "
                   "candidate (grad only)")
    p.add_argument("--iters", type=int, default=64)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the card (default) or the plain versions on the "
                   "CPU")
    p.add_argument("--out", type=str, default=None,
                   help="also write the markdown table to this path")
    args = p.parse_args(argv)

    records = autotune(
        seq_len=args.seq_len, batch=args.batch, n_heads=args.heads,
        kv_heads=args.kv_heads, head_dim=args.head_dim, mode=args.mode,
        sweep_bwd=args.sweep_bwd, iters=args.iters, device=args.device,
    )
    md = to_markdown(
        records, seq_len=args.seq_len, batch=args.batch,
        n_heads=args.heads, kv_heads=args.kv_heads or args.heads,
        head_dim=args.head_dim,
        device_kind=(torch.cuda.get_device_name() if args.device == "cuda"
                     else "cpu (plain versions)"),
    )
    print(md)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
