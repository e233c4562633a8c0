"""Roofline step-time estimator and the per-card peak table.

Port of the JAX package's ``checks/roofline.py``, keyed on
``torch.cuda.get_device_name`` instead of a TPU ``device_kind``:

* **the card table** (``ChipSpec`` / ``CHIPS`` / the device-name prefix
  table, a lookup by name and one by device): the one table every MFU
  and bound divides by -- the training MFU (``train/__main__.py``), the
  serving MFU (``serve/server.py``), the kernel bounds of
  ``chip_smoke.py``, the fit analyzer's HBM verdict (``checks/fit.py``)
  and the collective planner's alpha-beta fabric (``comm/planner.py``
  reads its bandwidths from the ``h100-sxm`` row, so the two never
  disagree);
* **the estimator**: "is this (model, mesh, batch) compute-, memory-,
  or communication-bound, and what MFU can it possibly reach?", with
  the JAX package's formulas unchanged. Three lower bounds per step:
  compute (model FLOPs / peak x cards, the 6ND convention via
  ``LlamaConfig.flops_per_token``), memory (bytes each card must move
  through HBM per step / HBM bandwidth) and comm (per-strategy
  collective bytes over the slowest axis' link, ring cost model). The
  JAX names stay: ``ici`` is the fabric inside a node (NVLink), ``dcn``
  the network between nodes (one NIC per card), and ``slices`` the
  nodes the data axis spans.

``step_time_lower_bound = max(compute, memory, comm)`` -- a bound, not a
prediction: a perfect schedule overlaps the three, a real one adds gaps.
``--measured`` calibrates the card's rates with
``env_check.chip_microbench`` on this machine's card.

Rows: NVIDIA's H100 data sheet, dense rates (no sparsity), at the card's
full power limit (700 W SXM, 350 W PCIe). A card set below its limit
runs slower under load; ``nvidia-smi`` reports the limit, and every
measured number the repo keeps carries it. The fabric figures are
spec-sheet too: 80 GB of HBM (an H100 SXM's torch.cuda reports
85,017,493,504 B, 79.18 GiB, of which the allocator can hand out
slightly less: a fit within a GiB of 80 is tight); NVLink 4 gives an
H100 SXM 450 GB/s a direction; a PCIe
card talks over PCIe Gen5 x16, 64 GB/s a direction; between nodes one
400 Gb/s NIC (ConnectX-7, NDR InfiniBand) a card, 50 GB/s a direction.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional

import torch

from tpu_hpc_torch.models import llama2

GIB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Published per-card numbers. ``peak_fp32_flops`` is the rate
    outside the tensor cores (plain fp32 FMAs), ``peak_tf32_flops`` the
    tensor cores' TF32 rate (dense), which the split-TF32 kernels run
    at (three TF32 products for one fp32 product of two split
    operands: chip_smoke.py's ``bound_tf32``). ``ici_gbps`` is ONE
    direction of the card's link inside a node, ``dcn_gbps`` its share
    of the network between nodes (one NIC per card), both GB/s;
    ``hbm_gib`` is capacity (the fit analyzer owns does-it-fit, this
    module owns how-fast)."""

    name: str
    peak_bf16_flops: float
    peak_fp32_flops: float
    hbm_gbps: float
    hbm_gib: float = 80.0
    ici_gbps: float = 450.0
    dcn_gbps: float = 50.0
    peak_tf32_flops: float = 495e12

    @property
    def hbm_bytes_per_s(self) -> float:
        return self.hbm_gbps * 1e9

    def peak_flops(self, dtype: torch.dtype) -> float:
        """Peak FLOP/s for operands of ``dtype`` (bf16 and fp16 share
        the tensor-core rate; fp32 runs outside the tensor cores)."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_bf16_flops
        if dtype == torch.float32:
            return self.peak_fp32_flops
        raise ValueError(f"no peak rate for {dtype}")


CHIPS: Dict[str, ChipSpec] = {
    "h100-sxm": ChipSpec("h100-sxm", 989e12, 67e12, 3350, 80.0, 450.0, 50.0,
                         495e12),
    "h100-pcie": ChipSpec("h100-pcie", 756e12, 51e12, 2000, 80.0, 64.0, 50.0,
                          378e12),
}


# torch.cuda.get_device_name spellings -> CHIPS key, longest prefix
# first. The SXM part names itself by its memory ("NVIDIA H100 80GB
# HBM3"); an H100 this table does not know (NVL, H100 on other memory)
# resolves to nothing rather than to a neighbour's rates.
_DEVICE_KIND_PREFIXES = (
    ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 SXM", "h100-sxm"),
)


def chip_for_kind(kind: str) -> Optional[ChipSpec]:
    """The ``ChipSpec`` of a device name (``torch.cuda.get_device_name``),
    by longest-prefix match; None for cards the table does not know."""
    for prefix, key in _DEVICE_KIND_PREFIXES:
        if kind.startswith(prefix):
            return CHIPS[key]
    return None


def peak_flops_for_kind(kind: str, default=None):
    """Peak dense bf16 FLOP/s for a device name, by longest-prefix match
    (the JAX package's signature); ``default`` for names the table does
    not know. For readers that hold only a recorded name, not a live
    device: the obs report resolves the ``device_kind`` a run_start
    record stamped, possibly on a machine with no card."""
    chip = chip_for_kind(kind)
    return chip.peak_bf16_flops if chip is not None else default


def peak_flops_for_device(device: torch.device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a torch device; None for the CPU and for
    cards the table does not know (an MFU against a guessed peak would
    be noise, so callers report none)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    chip = chip_for_kind(torch.cuda.get_device_name(device))
    return chip.peak_bf16_flops if chip is not None else None


def _ring_collective_s(bytes_full: int, n: int, bw_gbps: float) -> float:
    """Ring all-gather/reduce-scatter time: every chip sends/receives
    (n-1)/n of the full buffer over one link (bidirectional rings halve
    this; we keep the conservative single-direction figure)."""
    if n <= 1:
        return 0.0
    return bytes_full * (n - 1) / n / (bw_gbps * 1e9)


@dataclasses.dataclass
class RooflineResult:
    chip: ChipSpec
    dp: int
    axis2: int                  # tp, cp, or pp degree
    layout: str                 # "tp" | "cp" | "pp" | "dp" (axis2 == 1)
    global_batch: int
    seq_len: int
    grad_accum: int
    tokens_per_step: int
    compute_s: float
    memory_s: float
    comm_s: float
    comm_breakdown: Dict[str, float]
    memory_breakdown: Dict[str, float]
    # Multiplies compute_s in the step bound but NOT in MFU's
    # numerator: schedule-inherent FLOP overheads (the 1F1B backward's
    # forward remat) and idle time (pipeline bubble). 1.0 for tp/cp.
    schedule_factor: float = 1.0
    slices: int = 1             # DCN slices the data axis spans

    @property
    def chips(self) -> int:
        return self.dp * self.axis2

    @property
    def step_time_lower_bound_s(self) -> float:
        return max(
            self.compute_s * self.schedule_factor,
            self.memory_s, self.comm_s,
        )

    @property
    def bound(self) -> str:
        t = self.step_time_lower_bound_s
        if t == self.compute_s * self.schedule_factor:
            return "compute" if self.schedule_factor == 1.0 else "schedule"
        return "memory" if t == self.memory_s else "comm"

    @property
    def mfu_upper_bound(self) -> float:
        return self.compute_s / self.step_time_lower_bound_s

    @property
    def tokens_per_s_per_chip_bound(self) -> float:
        return (
            self.tokens_per_step
            / self.step_time_lower_bound_s
            / self.chips
        )


def measured_chip_spec(base: "ChipSpec") -> "ChipSpec":
    """Calibrate a spec-sheet ChipSpec against THIS machine's card: run
    the env-check microbenchmark (checks/env_check.py:chip_microbench)
    and substitute the measured bf16 matmul rate and HBM copy
    bandwidth. Link rates and capacity keep the spec values (one card
    cannot measure its links). With measured rates the roofline turns
    from "what the spec sheet allows" into "what this card will
    actually deliver", which moves memory-bound verdicts."""
    from tpu_hpc_torch.checks.env_check import chip_microbench

    rates = chip_microbench()
    return dataclasses.replace(
        base,
        name=f"{base.name}-measured",
        peak_bf16_flops=rates["matmul_tflops"] * 1e12,
        hbm_gbps=rates["hbm_gb_s"],
    )


def estimate(
    cfg: Optional[llama2.LlamaConfig] = None,
    chip: "str | ChipSpec" = "h100-sxm",
    dp: int = 1,
    axis2: int = 1,
    layout: str = "tp",
    global_batch: int = 4,
    seq_len: Optional[int] = None,
    grad_accum: int = 1,
    moments_dtype: str = "float32",
    slices: int = 1,
    pp_backward: str = "remat",
) -> RooflineResult:
    """Roofline bounds for one training step of the Llama family.

    ``layout="tp"``: hybrid FSDP(data) x Megatron-TP+SP(model).
    ``layout="cp"``: FSDP(data) x ring-attention context(axis2).
    ``layout="pp"``: DP(data) x pipeline(axis2 stages), 1F1B schedule
    with ``grad_accum`` microbatches -- the schedule's bubble and
    backward-remat overheads enter the step bound via
    ``schedule_factor`` (and so depress the MFU ceiling) without
    inflating MFU's FLOP numerator.
    ``axis2=1`` degenerates to DP/FSDP-only either way.
    ``slices > 1``: the data axis spans that many nodes over the
    inter-node network (the JAX package's DCN slices); its collective's
    cross-node phase runs at
    ``chip.dcn_gbps`` and the axis term takes the slower of the two
    phases -- the quantitative form of "only FSDP crosses slices".
    ``chip`` is a CHIPS key or a ChipSpec (e.g. measured_chip_spec's
    host-calibrated rates).
    """
    if cfg is None:
        cfg = llama2.LlamaConfig()
    if layout not in ("tp", "cp", "pp"):
        raise ValueError(f"unknown layout {layout!r} (tp|cp|pp)")
    c = CHIPS[chip] if isinstance(chip, str) else chip
    s = seq_len or cfg.max_seq_len
    n_chips = dp * axis2
    tokens = global_batch * s
    if grad_accum < 1 or global_batch % (dp * grad_accum):
        # Same contract as fit.analyze: a silently truncated bl would
        # zero the activation/comm terms and the tool would name a
        # binding constraint for a configuration that cannot run.
        raise ValueError(
            f"global_batch {global_batch} must divide into dp {dp} x "
            f"grad_accum {grad_accum} microbatch rows"
        )
    if layout != "pp" and s % max(axis2, 1):
        raise ValueError(
            f"seq_len {s} must be divisible by the second mesh axis "
            f"{axis2} (fit.analyze rejects the same configuration)"
        )
    if layout == "pp" and cfg.n_layers % max(axis2, 1):
        raise ValueError(
            f"pipeline needs n_layers {cfg.n_layers} divisible by "
            f"the stage count {axis2}"
        )
    if slices > 1 and dp % slices:
        raise ValueError(
            f"dp {dp} must be divisible by slices {slices} "
            f"(the DCN component of the data axis)"
        )
    n_params = llama2.count_params(cfg)

    # -- compute bound (the MFU denominator) --
    compute_s = (
        tokens * cfg.flops_per_token(s) / (c.peak_bf16_flops * n_chips)
    )

    if layout == "pp":
        return _estimate_pp(
            cfg, c, dp, axis2, global_batch, s, grad_accum,
            moments_dtype, tokens, compute_s, slices,
            pp_backward=pp_backward,
        )

    # -- memory bound: per-chip HBM bytes each step must move --
    shard = dp * (axis2 if layout == "tp" else 1)  # param shard ways
    p_local = n_params / shard
    bf16, f32 = 2, 4
    mom = 2 if moments_dtype == "bfloat16" else 4
    bl = global_batch // dp
    s_loc = s // axis2 if layout == "cp" else s // max(axis2, 1)
    mem = {
        # bf16 params read once per fwd and once per bwd per microbatch
        "param_reads": grad_accum * 2 * p_local * bf16,
        "grad_write_and_opt": p_local * (f32 + 2 * (f32 + mom)),
        # checkpointed residuals written in fwd, read in bwd
        "activation_checkpoints": (
            2 * (cfg.n_layers + 1) * bl * s_loc * cfg.dim * bf16
        ),
        "logits_roundtrip": 2 * bl * s_loc * cfg.vocab_size * bf16,
    }
    memory_s = sum(mem.values()) / (c.hbm_gbps * 1e9)

    # -- comm bound: per-axis terms; the bound takes the MAX because
    # different axes ride disjoint ICI links (to_markdown says so) --
    comm: Dict[str, float] = {}
    if dp > 1:
        # FSDP: bf16 param gathers fwd+bwd per microbatch + one fp32
        # gradient reduce-scatter per step.
        gather_bytes = grad_accum * 2 * n_params / (
            axis2 if layout == "tp" else 1
        ) * bf16
        rs_bytes = n_params / (axis2 if layout == "tp" else 1) * f32
        comm["fsdp_data_axis"] = _two_tier_collective_s(
            int(gather_bytes + rs_bytes), dp, slices, c
        )
    if axis2 > 1 and layout == "tp":
        # Megatron-SP: RS+AG pair twice per layer fwd and twice bwd on
        # [bl_micro, s, d] bf16 activations, once per microbatch --
        # totals the same bytes as one full-batch pass, so use the
        # whole per-row batch `bl` exactly once (NOT bl * grad_accum:
        # the microbatches each carry 1/grad_accum of the rows).
        act_bytes = bl * s * cfg.dim * bf16
        comm["tp_model_axis"] = (
            cfg.n_layers * 4 * 2
            * _ring_collective_s(act_bytes, axis2, c.ici_gbps)
        )
    if axis2 > 1 and layout == "cp":
        # KV ring, three full rotations per layer: forward, the
        # backward's remat recompute of the forward ring, and the
        # dk/dv cotangent return ring. Same whole-batch-once
        # accounting as above.
        kv_bytes = 2 * bl * s_loc * cfg.kv_heads * cfg.head_dim * bf16
        hop = kv_bytes / (c.ici_gbps * 1e9)
        comm["kv_ring_context_axis"] = (
            cfg.n_layers * 3 * (axis2 - 1) * hop
        )
    comm_s = max(comm.values()) if comm else 0.0

    return RooflineResult(
        chip=c, dp=dp, axis2=axis2,
        layout=layout if axis2 > 1 else "dp",
        global_batch=global_batch, seq_len=s, grad_accum=grad_accum,
        tokens_per_step=tokens,
        compute_s=compute_s, memory_s=memory_s, comm_s=comm_s,
        comm_breakdown=comm, memory_breakdown=mem,
        slices=slices,
    )


def _two_tier_collective_s(
    bytes_full: int, n: int, slices: int, c: ChipSpec
) -> float:
    """Data-axis collective time when the axis spans ``slices`` DCN
    slices: the intra-slice phase rings (n/slices)-wide over ICI, the
    cross-slice phase moves each chip's 1/n shard (slices-1)/slices
    of the way over its DCN share. The axis is bound by the slower
    phase (the phases pipeline in a well-scheduled hierarchical
    collective)."""
    if slices <= 1:
        return _ring_collective_s(bytes_full, n, c.ici_gbps)
    per_slice = n // slices
    ici_s = _ring_collective_s(bytes_full, per_slice, c.ici_gbps)
    dcn_bytes = bytes_full / n * (slices - 1)
    return max(ici_s, dcn_bytes / (c.dcn_gbps * 1e9))


def _estimate_pp(
    cfg, c: ChipSpec, dp: int, stages: int, global_batch: int,
    s: int, microbatches: int, moments_dtype: str,
    tokens: int, compute_s: float, slices: int,
    pp_backward: str = "remat",
) -> RooflineResult:
    """Pipeline layout bounds: stage-sharded params (replicated over
    ``data`` -- the repo's PP x DP composition, pp.stage_pspecs),
    1F1B schedule with ``microbatches`` microbatches per step.

    Two schedule-inherent overheads enter ``schedule_factor``:
      * bubble: wall ticks / work ticks = (M + S - 1) / M
        (pp.bubble_fraction's exact v=1 form), and
      * the custom-vjp backward's extra stage forwards. Counting in
        fwd-units (fwd 1, bwd 2, ideal total 3): the loss forward +
        the combined program's own fwd slot already cost one extra
        unit (4/3); ``pp_backward="remat"`` (pp.pipelined's default)
        recomputes each stage forward a second time in its backward
        slot -- 5/3 -- while ``"stash"`` saves the vjp residuals at
        forward time and stays at 4/3.
    Neither inflates MFU's numerator -- a 4-stage 8-microbatch plan
    honestly shows its bubble-and-remat-depressed ceiling instead of
    pretending the overheads away.
    """
    bf16, f32 = 2, 4
    mom = 2 if moments_dtype == "bfloat16" else 4
    M = microbatches
    # Worst stage: its share of layers plus the embed/head edge
    # weights -- doctor plans must fit the worst chip.
    p_stage = llama2.pp_worst_stage_params(cfg, stages)
    bl = global_batch // dp           # rows per data shard per step
    mem = {
        # bf16 stage params re-read fwd+bwd each microbatch tick.
        "param_reads": M * 2 * p_stage * bf16,
        "grad_write_and_opt": p_stage * (f32 + 2 * (f32 + mom)),
        # Per-layer residual checkpoints written fwd / read bwd, all
        # rows across the step (microbatching splits, not shrinks).
        "activation_checkpoints": (
            2 * (cfg.n_layers // stages + 1) * bl * s * cfg.dim * bf16
        ),
        # Last stage's logits roundtrip (worst chip again).
        "logits_roundtrip": 2 * bl * s * cfg.vocab_size * bf16,
    }
    if pp_backward == "stash":
        # Stash is not free: the vjp residuals (every per-layer
        # intermediate -- qkv, attention out, both SwiGLU hiddens --
        # plus a compute-dtype copy of the stage params per
        # microbatch) are written at forward time and read back in
        # the backward, where remat only moves the 2*dim/layer/token
        # checkpoints. ~(dim + (h+2kv+h)*hd + 2*ffn) per layer-token.
        per_tok = (
            cfg.dim
            + (cfg.n_heads + 2 * cfg.kv_heads + cfg.n_heads)
            * cfg.head_dim
            + 2 * cfg.ffn_hidden
        )
        mem["stash_residuals"] = (
            2 * (cfg.n_layers // stages) * bl * s * per_tok * bf16
            + 2 * M * p_stage * bf16  # per-microbatch param copies
        )
    memory_s = sum(mem.values()) / (c.hbm_gbps * 1e9)

    comm = {}
    if stages > 1:
        # Stage-boundary activation hops: every row crosses each
        # boundary once fwd (bf16 acts) + once bwd (bf16 grads) on a
        # neighbor ICI link -- M microbatches of bl/M rows each.
        comm["pp_stage_hops"] = (
            2 * bl * s * cfg.dim * bf16 / (c.ici_gbps * 1e9)
        )
    if dp > 1:
        # DDP over data: one fp32 gradient all-reduce of the stage
        # shard per step (ring all-reduce moves ~2x the buffer).
        comm["ddp_grad_allreduce"] = _two_tier_collective_s(
            2 * p_stage * f32, dp, slices, c
        )
    comm_s = max(comm.values()) if comm else 0.0

    bubble_stretch = (M + stages - 1) / M
    if pp_backward not in ("remat", "stash"):
        raise ValueError(
            f"unknown pp_backward {pp_backward!r} (remat|stash)"
        )
    extra_fwds = 5.0 / 3.0 if pp_backward == "remat" else 4.0 / 3.0
    return RooflineResult(
        chip=c, dp=dp, axis2=stages,
        layout="pp" if stages > 1 else "dp",
        global_batch=global_batch, seq_len=s, grad_accum=M,
        tokens_per_step=tokens,
        compute_s=compute_s, memory_s=memory_s, comm_s=comm_s,
        comm_breakdown=comm, memory_breakdown=mem,
        schedule_factor=bubble_stretch * extra_fwds,
        slices=slices,
    )


def to_markdown(r: RooflineResult, cfg: llama2.LlamaConfig) -> str:
    ms = 1e3
    lines = [
        f"# Roofline -- {r.chips}x {r.chip.name} "
        f"(data={r.dp} x {r.layout}={r.axis2}), "
        f"batch {r.global_batch} x seq {r.seq_len}"
        + (f", accum {r.grad_accum}" if r.grad_accum > 1 else ""),
        "",
        f"Model: dim={cfg.dim}, layers={cfg.n_layers}, "
        f"{cfg.flops_per_token(r.seq_len)/1e6:.0f} MFLOP/token.",
        "",
        "| bound | time/step | detail |",
        "|---|---|---|",
        f"| compute | {r.compute_s*ms:.2f} ms | model FLOPs at "
        f"{r.chip.peak_bf16_flops/1e12:.0f} TF/chip peak |"
        + (
            f"\n| schedule | {r.compute_s*r.schedule_factor*ms:.2f} ms "
            f"| compute x {r.schedule_factor:.2f} (pipeline bubble + "
            f"1f1b backward remat) |"
            if r.schedule_factor != 1.0 else ""
        ),
        f"| memory | {r.memory_s*ms:.2f} ms | "
        + ", ".join(
            f"{k} {v/GIB:.2f} GiB" for k, v in r.memory_breakdown.items()
        )
        + f" at {r.chip.hbm_gbps:.0f} GB/s |",
        f"| comm | {r.comm_s*ms:.2f} ms | "
        + (
            ", ".join(
                f"{k} {v*ms:.2f} ms" for k, v in r.comm_breakdown.items()
            )
            if r.comm_breakdown else "single chip: none"
        )
        + " |",
        "",
        f"**Binding constraint: {r.bound}.** Step time >= "
        f"{r.step_time_lower_bound_s*ms:.2f} ms -> MFU <= "
        f"{r.mfu_upper_bound:.1%}, throughput <= "
        f"{r.tokens_per_s_per_chip_bound:,.0f} tokens/s/chip.",
        "",
        "Bounds assume perfect overlap within each category and none "
        "across categories; a measured step lands between the max and "
        "the sum. Axis collectives ride disjoint links, so only "
        "the slowest axis is counted in the comm bound.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=sorted(llama2.PRESETS), default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--dim", type=int, default=None,
                   help="override model dim (with --heads/--vocab, "
                   "bounds arbitrary architectures)")
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--kv-heads", type=int, default=None)
    p.add_argument("--vocab", type=int, default=None)
    p.add_argument("--chip", choices=sorted(CHIPS), default="h100-sxm")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--cp", type=int, default=0,
                   help="ring/context degree (switches layout to cp)")
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline stage count (switches layout to pp; "
                   "--grad-accum is the microbatch count)")
    p.add_argument("--slices", type=int, default=1,
                   help="nodes the data axis spans (the model axis stays "
                   "inside a node); the cross-node phase is costed at "
                   "dcn_gbps")
    p.add_argument("--global-batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--moments-dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--pp-backward", choices=("remat", "stash"),
                   default="remat",
                   help="1f1b backward the --pp bound models: remat = "
                   "5/3 extra-forward factor, stash = 4/3 plus the "
                   "stash_residuals memory term")
    p.add_argument(
        "--measured", action="store_true",
        help="calibrate --chip against this machine's card: run the "
        "env-check microbenchmark and use the measured matmul TFLOP/s "
        "and HBM GB/s instead of the spec-sheet rates (ICI stays spec)",
    )
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    import dataclasses as dc

    cfg = (
        llama2.PRESETS[args.model] if args.model
        else llama2.LlamaConfig(
            dim=1024, n_layers=8, n_heads=8, vocab_size=32000,
            multiple_of=256, max_seq_len=2048,
        )  # the bench model
    )
    if args.seq_len:
        cfg = dc.replace(cfg, max_seq_len=args.seq_len)
    overrides = {
        k: v for k, v in (
            ("n_layers", args.layers), ("dim", args.dim),
            ("n_heads", args.heads), ("n_kv_heads", args.kv_heads),
            ("vocab_size", args.vocab),
        ) if v is not None
    }
    if overrides:
        cfg = dc.replace(cfg, **overrides)
    chip = (
        measured_chip_spec(CHIPS[args.chip]) if args.measured
        else args.chip
    )
    if sum(bool(x) for x in (args.cp, args.pp)) > 1:
        p.error("--cp and --pp are mutually exclusive")
    r = estimate(
        cfg, chip=chip, dp=args.dp,
        axis2=args.pp or args.cp or args.tp,
        layout="pp" if args.pp else ("cp" if args.cp else "tp"),
        global_batch=args.global_batch,
        seq_len=args.seq_len or cfg.max_seq_len,
        grad_accum=args.grad_accum,
        moments_dtype=args.moments_dtype,
        slices=args.slices,
        pp_backward=args.pp_backward,
    )
    if args.json:
        print(json.dumps({
            # Disclose the calibration: "<chip>-measured" + the rates
            # actually used, so a recorded JSON artifact is
            # distinguishable from a spec-sheet run.
            "chip": r.chip.name,
            "peak_bf16_tflops": round(r.chip.peak_bf16_flops / 1e12, 1),
            "hbm_gb_s": round(r.chip.hbm_gbps, 1),
            "bound": r.bound,
            "step_time_lower_bound_ms":
                round(r.step_time_lower_bound_s * 1e3, 3),
            "mfu_upper_bound": round(r.mfu_upper_bound, 4),
            "tokens_per_s_per_chip_bound":
                round(r.tokens_per_s_per_chip_bound, 1),
            "compute_ms": round(r.compute_s * 1e3, 3),
            "memory_ms": round(r.memory_s * 1e3, 3),
            "comm_ms": round(r.comm_s * 1e3, 3),
        }))
    else:
        print(to_markdown(r, cfg))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
