#!/usr/bin/env python3
"""Guarded, checkpointed bench-Llama training across the cards of one host.

Three runs of ``python -m tpu_hpc_torch.train`` under ``torchrun`` on
``--nproc`` cards, over one checkpoint directory, ``--guard-mode skip``
and a save every epoch:

  1. (data 2, model N/2), hybrid FSDP x TP + SP, the first epoch, with
     ``nan_loss_at_step=1``: every rank takes the one poisoned verdict
     and skips the update;
  2. the same mesh, resumed, with ``preempt_at_step=4``: every rank
     snapshots at the end of epoch 2 and exits 75 (EXIT_RESUMABLE;
     torchrun reports the failed workers with its own code);
  3. (data N, model 1), FSDP: resumes from that snapshot (DCP reshards
     the hybrid layout into the FSDP one) and trains the last epoch.

Every run trains the same global batch (``--global-batch``, split over
the data axis; the CLI's ``--batch`` is a data rank's), so the job
continues on the new mesh where it stopped on the old one.

Each run prints the CLI's JSON summary; this script adds the run log's
guard verdicts, checkpoint steps and restore checksum verdicts, a check
of each (run 2's restore on the save mesh compares every rank's shard
checksums as well as the whole leaves'; run 3's, resharded, the whole
leaves'), and ends with
``nvidia-smi``'s name and power limit of each card. From the repository
root:

    python3 docs/port/multicard_resilience.py                 # 4 cards
    python3 docs/port/multicard_resilience.py --device cpu \\
        --global-batch 8 --accum 2 -- --dim 64 --n-layers 2 --n-heads 4 \\
        --vocab 128 --multiple-of 16 --seq-len 32

(the second rehearses on the CPU over gloo; flags after ``--`` go to
every run).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def run(cmd, env, timeout: float):
    """One torchrun in its own process group (killed whole past
    ``timeout``): (exit code, its last JSON line or None, stderr tail)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return proc.returncode, json.loads(lines[-1]) if lines else None, \
        err[-3000:]


def events(path, kind):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("event") == kind]


def main() -> int:
    argv = sys.argv[1:]
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--global-batch", type=int, default=64)
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--workdir", default="build/multicard_resilience")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    ck = os.path.join(args.workdir, "ck")
    n = args.nproc
    if args.device == "cuda":
        # One build before the ranks start (they would race for it).
        from tpu_hpc_torch.kernels import _build

        _build.build()
    base = ["torchrun", "--standalone", f"--nproc-per-node={n}", "-m",
            "tpu_hpc_torch.train", "--device", args.device, "--steps",
            str(args.steps), "--grad-accum-steps", str(args.accum),
            "--guard-mode", "skip", "--checkpoint-dir", ck, "--save-every",
            "1", *extra]

    def mesh(data):
        return ["--data", str(data), "--model", str(n // data), "--batch",
                str(args.global_batch // data)]

    runs = (("nan_skip", mesh(2), 1, "nan_loss_at_step=1"),
            ("preempt", mesh(2), 3, f"preempt_at_step={2 * args.steps}"),
            ("resume_fsdp", mesh(n), 3, ""))
    ok = True
    for name, mesh, epochs, faults in runs:
        metrics = os.path.join(args.workdir, f"{name}.jsonl")
        env = dict(os.environ, TPU_HPC_FAULTS=faults)
        rc, summary, err = run([*base, *mesh, "--epochs", str(epochs),
                                "--metrics", metrics], env, args.timeout)
        verdicts = [(r["step"], r["verdict"], r["action"])
                    for r in events(metrics, "guard_verdict")]
        integ = [(r["step"], r["verdict"], r["checked"])
                 for r in events(metrics, "ckpt_integrity")]
        end = (events(metrics, "run_end") or [{}])[-1]
        steps = sorted(int(s) for s in os.listdir(ck) if s.isdigit()) \
            if os.path.isdir(ck) else []
        row = {"run": name, "mesh": mesh, "faults": faults, "rc": rc,
               "verdicts": verdicts, "integrity": integ, "run_end": end,
               "steps_on_disk": steps, "summary": summary}
        if name == "nan_skip":
            good = rc == 0 and verdicts == [(1, "poisoned", "skip")]
        elif name == "preempt":
            with open(os.path.join(ck, ".tpu_hpc_meta",
                                   f"{args.steps}.json")) as f:
                meta = json.load(f)
            # Rank 0 logs: its whole leaves' and its shards' checksums.
            sums = len(meta["checksums"]) + len(
                meta.get("shard_checksums", {}).get("0", {}))
            row["sums_on_rank0"] = sums
            good = rc != 0 and end.get("preempted") is True \
                and end.get("resumed_from_step") == args.steps \
                and 2 * args.steps in steps \
                and integ == [(args.steps, "ok", sums)] \
                and sums > len(meta["checksums"])
        else:
            good = rc == 0 and summary is not None \
                and end.get("resumed_from_step") == 2 * args.steps \
                and summary["plan"] == "fsdp" \
                and summary["global_batch"] == args.global_batch and all(
                    x == x for x in summary["losses"]) \
                and [v for _, v, _ in integ] == ["ok"]
        row["ok"] = good
        ok = ok and good
        if not good:
            row["stderr"] = err
        print(json.dumps(row), flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
