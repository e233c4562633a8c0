"""The strategy chooser as one command: fit + roofline, ranked.

Port of the JAX package's ``checks/doctor.py``: the reference states
the decision procedure as rules of thumb (its choosing-a-strategy
guide); ``python -m tpu_hpc_torch.checks.doctor`` executes it. Given
(model, card count, card type, batch), it enumerates every legal mesh,
asks the fit analyzer whether each fits per-card HBM (raising grad
accumulation until it does), asks the roofline estimator how fast each
can possibly go, and prints the candidates ranked with one
recommendation and the commands that reproduce the analysis.

Everything here is glue: the numbers come from ``checks.fit.analyze``
(the port's param tree on the meta device + the sharding plans, the
analytic terms) and ``checks.roofline.estimate`` (the calibratable
three-bound model) -- the doctor cannot disagree with the deeper tools
because it has no model of its own.

H100 jobs come in nodes of ``CARDS_PER_NODE`` cards: by default the
cards span ``ceil(chips / 8)`` nodes (the JAX ``slices``), the data
axis crosses the inter-node network and the model axis stays inside a
node; plans whose data axis does not divide into the nodes are dropped.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from tpu_hpc_torch.checks import fit as fit_mod
from tpu_hpc_torch.checks.roofline import (
    CHIPS,
    ChipSpec,
    RooflineResult,
    estimate,
    measured_chip_spec,
)
from tpu_hpc_torch.models import llama2

GIB = 1 << 30
CARDS_PER_NODE = 8

ACCUM_LADDER = (1, 2, 4, 8, 16, 32, 64)


@dataclasses.dataclass
class Plan:
    """One candidate (mesh, accum) with its fit and speed verdicts."""

    layout: str          # "tp" | "cp" | "pp"
    dp: int
    axis2: int           # tp/cp/pp degree (1 = pure FSDP/DP)
    grad_accum: int      # pp: the microbatch count
    fits: bool
    hbm_used_gib: float
    hbm_frac: float      # of the chip's capacity
    roofline: RooflineResult

    @property
    def mesh(self) -> str:
        if self.axis2 == 1:
            return f"fsdp {self.dp}"
        return f"dp {self.dp} x {self.layout} {self.axis2}"

    @property
    def score(self) -> "tuple[float, float]":
        """Rank key: unfittable plans sink; among the fitting, the
        highest achievable throughput bound wins (MFU bound would tie
        layouts that trade FLOP efficiency for comm differently), and
        speed ties break toward HBM headroom -- a 91%-full plan and a
        63%-full plan with the same ceiling are not equally safe."""
        if not self.fits:
            return (-1.0, -self.hbm_frac)
        return (
            self.roofline.tokens_per_s_per_chip_bound, -self.hbm_frac
        )


def _axis2_candidates(
    cfg: llama2.LlamaConfig, chips: int, layout: str, seq_len: int
) -> List[int]:
    """Legal second-axis degrees: divisors of the card count that the
    layout's own divisibility rules accept. TP additionally capped at
    8 -- one node's NVLink domain; beyond it the per-block reductions
    cross the inter-node network and dominate; PP at 16 stages -- deeper pipes need microbatch counts
    the accum ladder tops out before (the roofline would show both,
    but the candidates list stays readable)."""
    out = []
    for d in range(1, min(chips, 64) + 1):
        if chips % d:
            continue
        if layout == "tp":
            if d > 8 or cfg.n_heads % d or cfg.kv_heads % d:
                continue
        elif layout == "pp":
            if d == 1 or d > 16 or cfg.n_layers % d:
                continue
        else:
            if d == 1 or seq_len % d:
                continue
        out.append(d)
    return out


def _min_fitting_accum(
    cfg, dp, axis2, layout, global_batch, seq_len, hbm_gib,
    moments_dtype, max_accum, pp_backward="remat",
) -> "tuple[int, Optional[fit_mod.FitResult]]":
    """Smallest grad-accum on the ladder whose microbatch still covers
    the dp axis and whose analyzed footprint fits; (accum, None) with
    the last attempt when nothing fits."""
    last = None
    for accum in ACCUM_LADDER:
        if accum > max_accum:
            break
        if global_batch % accum or (global_batch // accum) % dp:
            continue
        r = fit_mod.analyze(
            cfg, dp=dp, tp_size=axis2, global_batch=global_batch,
            seq_len=seq_len, hbm_gib=hbm_gib, do_compile=False,
            grad_accum=accum, moments_dtype=moments_dtype,
            layout=layout, pp_backward=pp_backward,
        )
        last = (accum, r)
        if r.total_bytes <= hbm_gib * GIB:
            return accum, r
    return last if last is not None else (1, None)


def default_nodes(chips: int) -> int:
    """Nodes ``chips`` cards span at ``CARDS_PER_NODE`` a node."""
    return -(-chips // CARDS_PER_NODE)


def diagnose(
    model: str = "7b",
    chips: int = 32,
    chip: "str | ChipSpec" = "h100-sxm",
    global_batch: int = 256,
    seq_len: Optional[int] = None,
    moments_dtype: str = "float32",
    long_context: bool = False,
    max_accum: int = 64,
    measured: bool = False,
    slices: Optional[int] = None,
    pp_backward: str = "remat",
) -> List[Plan]:
    """Rank every legal (mesh, accum) plan for the configuration.

    ``long_context`` adds the FSDP x ring-attention (cp) layouts to
    the candidate set (they are always added when seq_len >= 32768).
    Pipeline (pp) layouts are always in the candidate set -- the
    strategy guide's decision space (its chapter 11) includes them.
    ``slices``: the nodes the cards span (None: ``default_nodes``);
    above 1 the data axis crosses the inter-node network (plans whose
    dp does not divide by the node count are dropped -- the model axis
    must stay inside a node). Returns plans sorted best-first; [0] is
    the recommendation.
    """
    if slices is None:
        slices = default_nodes(chips)
    cfg = llama2.PRESETS[model]
    if seq_len is not None:
        cfg = dataclasses.replace(cfg, max_seq_len=seq_len)
    seq_len = cfg.max_seq_len
    spec = CHIPS[chip] if isinstance(chip, str) else chip
    if measured:
        spec = measured_chip_spec(spec)

    layouts = ["tp", "pp"]
    if long_context or seq_len >= 32768:
        layouts.append("cp")
    plans: List[Plan] = []
    for layout in layouts:
        for axis2 in _axis2_candidates(cfg, chips, layout, seq_len):
            dp = chips // axis2
            if global_batch % dp:
                continue
            if slices > 1 and dp % slices:
                # The second axis may not straddle slice boundaries;
                # only the data axis rides DCN.
                continue
            accum, fitres = _min_fitting_accum(
                cfg, dp, axis2, layout, global_batch, seq_len,
                spec.hbm_gib, moments_dtype, max_accum,
                pp_backward=pp_backward,
            )
            if fitres is None:
                continue
            roof = estimate(
                cfg, chip=spec, dp=dp, axis2=axis2, layout=layout,
                global_batch=global_batch, seq_len=seq_len,
                grad_accum=accum, moments_dtype=moments_dtype,
                slices=slices, pp_backward=pp_backward,
            )
            plans.append(Plan(
                layout=layout, dp=dp, axis2=axis2, grad_accum=accum,
                fits=fitres.total_bytes <= spec.hbm_gib * GIB,
                hbm_used_gib=fitres.total_bytes / GIB,
                hbm_frac=fitres.total_bytes / (spec.hbm_gib * GIB),
                roofline=roof,
            ))
    plans.sort(key=lambda p: p.score, reverse=True)
    return plans


def to_markdown(
    plans: List[Plan], *, model: str, chips: int, chip_name: str,
    global_batch: int, seq_len: int, moments_dtype: str,
    slices: int = 1, pp_backward: str = "remat",
) -> str:
    tokens = global_batch * seq_len
    lines = [
        f"# doctor -- {model} on {chips}x {chip_name}"
        + (f" across {slices} nodes (data axis on the inter-node network)"
           if slices > 1 else "")
        + (f" [pp plans: {pp_backward} backward]"
           if pp_backward != "remat" else "")
        + f", batch {global_batch} x {seq_len} "
        f"({tokens / 1e6:.2f}M tokens/step)",
        "",
        "| mesh | accum | HBM/card | fits | bound | MFU <= | "
        "tok/s/card <= |",
        "|---|---|---|---|---|---|---|",
    ]
    for p in plans:
        r = p.roofline
        fits = "NO" if not p.fits else (
            "tight" if p.hbm_frac > 0.9 else "yes"
        )
        lines.append(
            f"| {p.mesh} | {p.grad_accum} | {p.hbm_used_gib:.1f} GiB "
            f"({p.hbm_frac:.0%}) | {fits} | "
            f"{r.bound} | {r.mfu_upper_bound:.1%} | "
            f"{r.tokens_per_s_per_chip_bound:,.0f} |"
        )
    lines.append("")
    if not plans or not plans[0].fits:
        lines += [
            "**No plan fits.** Every legal mesh exceeds per-card HBM "
            "even at the accumulation ladder's top -- add cards, use "
            "`--moments-dtype bfloat16`, or shrink the batch.",
            "",
        ]
        return "\n".join(lines)
    best = plans[0]
    axis_flag = f"--{best.layout} {best.axis2}"
    lines += [
        f"**Recommended: {best.mesh}, grad accum {best.grad_accum}** "
        f"-- {best.hbm_used_gib:.1f} GiB/card, "
        f"{best.roofline.bound}-bound, ceiling "
        f"{best.roofline.tokens_per_s_per_chip_bound:,.0f} "
        "tokens/s/card "
        f"(MFU <= {best.roofline.mfu_upper_bound:.1%}).",
        "",
        "Reproduce / deepen:",
        "```bash",
        f"python -m tpu_hpc_torch.checks.fit --model {model} "
        f"--dp {best.dp} {axis_flag} "
        f"--global-batch {global_batch} --seq-len {seq_len} "
        f"--grad-accum {best.grad_accum}"
        + (f" --moments-dtype {moments_dtype}"
           if moments_dtype != "float32" else "")
        + (f" --pp-backward {pp_backward}"
           if best.layout == "pp" and pp_backward != "remat" else "")
        + "  # runs one real update at the layout; --no-compile skips it",
        f"python -m tpu_hpc_torch.checks.roofline --model {model} "
        f"--dp {best.dp} {axis_flag} "
        f"--global-batch {global_batch} --seq-len {seq_len} "
        f"--grad-accum {best.grad_accum}"
        + (f" --pp-backward {pp_backward}"
           if best.layout == "pp" and pp_backward != "remat" else ""),
        "```",
        "",
        "The fit row is the analytic footprint; run one real update at "
        "the layout (checks.fit without --no-compile) before trusting a "
        "tight fit: it reports the measured peak beside the analytic "
        "total.",
        "",
    ]
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=sorted(llama2.PRESETS),
                   default="7b")
    p.add_argument("--chips", type=int, default=32)
    p.add_argument("--chip", choices=sorted(CHIPS), default="h100-sxm")
    p.add_argument("--global-batch", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--moments-dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--long-context", action="store_true",
                   help="also consider FSDP x ring-attention layouts")
    p.add_argument("--measured", action="store_true",
                   help="calibrate the roofline against this machine's "
                   "card (runs the env-check microbenchmark)")
    p.add_argument("--slices", type=int, default=None,
                   help="nodes the cards span (default: chips / 8, "
                   "rounded up): the data axis crosses the inter-node "
                   "network; layouts whose dp cannot divide into the "
                   "nodes are dropped")
    p.add_argument("--pp-backward", choices=("remat", "stash"),
                   default="remat",
                   help="1f1b backward for the pipeline plans: remat "
                   "(5/3 FLOPs, minimal memory) or stash (4/3, "
                   "Megatron-style, O(S) microbatches of residuals)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    plans = diagnose(
        args.model, args.chips, args.chip, args.global_batch,
        args.seq_len, args.moments_dtype, args.long_context,
        measured=args.measured, slices=args.slices,
        pp_backward=args.pp_backward,
    )
    seq = args.seq_len or llama2.PRESETS[args.model].max_seq_len
    slices = (default_nodes(args.chips) if args.slices is None
              else args.slices)
    if args.json:
        print(json.dumps([
            {
                "mesh": pl.mesh, "layout": pl.layout, "dp": pl.dp,
                "axis2": pl.axis2, "grad_accum": pl.grad_accum,
                "fits": pl.fits, "hbm_gib": round(pl.hbm_used_gib, 2),
                "bound": pl.roofline.bound,
                "mfu_upper_bound": round(
                    pl.roofline.mfu_upper_bound, 4
                ),
                "tokens_per_s_per_chip_bound": round(
                    pl.roofline.tokens_per_s_per_chip_bound, 1
                ),
            }
            for pl in plans
        ]))
    else:
        print(to_markdown(
            plans, model=args.model, chips=args.chips,
            chip_name=args.chip, global_batch=args.global_batch,
            seq_len=seq, moments_dtype=args.moments_dtype,
            slices=slices, pp_backward=args.pp_backward,
        ))
        # Cost-table inventory for the LIVE machine (not the modeled
        # --chips topology): does comm_mode="auto" here run on
        # measurements or on the alpha-beta fallback? One line, same
        # delegation discipline as the rest of the doctor -- the
        # verdict comes from comm/planner.py. Advisory: a machine whose
        # runtime cannot be reached must not take down the
        # (pure-arithmetic) analysis above.
        try:
            from tpu_hpc_torch.comm.planner import (
                format_inventory,
                table_inventory,
            )

            print(format_inventory(table_inventory()))
        except Exception as e:  # noqa: BLE001 -- advisory line only
            print(
                "comm cost tables: unavailable (backend not "
                f"reachable: {e}); run on the target host for the "
                "inventory"
            )
    return 0 if plans and plans[0].fits else 1


if __name__ == "__main__":
    sys.exit(main())
