"""``python -m tpu_hpc_torch.obs.bank BENCH_r*.json -o BENCH_HISTORY.jsonl``
-- normalize the banked bench history.

A framework-free copy of the JAX package's ``obs/bank.py``: the same
inputs give the same JSONL, which ``python -m tpu_hpc_torch.obs.regress
--bank`` reads.

The driver's per-round captures (``BENCH_r01.json`` ...) are ad-hoc
``{n, cmd, rc, tail, parsed}`` wrappers: the parsed bench record when
the round succeeded, a raw stderr tail when the backend was out. Four
of five rounds on record are outages, and the one schema any gate can
trust is obs/schema.py's -- so this converter lifts every capture into
one validated ``bench``-event JSONL:

* a successful round's ``parsed`` record becomes a ``bench`` event
  (metric/value/unit + whatever rode along), stamped with its round
  number, exit code and source file;
* a failed round becomes the same failure row ``bench.py --all``
  already emits (``value: null, unit: "FAILED"``, last stderr line as
  ``error``) -- outages are part of the trajectory, not silently
  dropped history;
* an ``MFU <x>%`` figure in the tail (the human headline line) is
  lifted into an ``mfu`` field so the bank keeps the number the
  PERFORMANCE.md table quotes.

Builder-recorded row files (``BENCH_EXTRA.jsonl``,
``HW_QUEUE_r05/bench_*.json`` single records) are accepted too: any
input that is already a bench record (or JSONL of them) is stamped and
passed through. The output is the ONE trusted input
``python -m tpu_hpc_torch.obs.regress --bank`` diffs candidates against.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List, Optional, Sequence

from tpu_hpc_torch.obs.schema import stamp, validate_record

_MFU_RE = re.compile(r"MFU (\d+(?:\.\d+)?)%")


def _lift_record(raw: dict, source: str, extra: dict) -> dict:
    """A record that already looks like a bench row -> stamped bench
    event."""
    rec = {"event": "bench", **raw, **extra, "source": source}
    return stamp(rec)


def lift_capture(data: dict, source: str) -> dict:
    """One driver capture ``{n, cmd, rc, tail, parsed}`` -> one
    stamped ``bench`` event."""
    extra = {"round": data.get("n"), "rc": data.get("rc")}
    tail = data.get("tail") or ""
    m = _MFU_RE.findall(tail)
    if m:
        extra["mfu"] = float(m[-1]) / 100.0
    parsed = data.get("parsed")
    if isinstance(parsed, dict) and "value" in parsed \
            and "unit" in parsed:
        return _lift_record(parsed, source, extra)
    err_lines = [l for l in tail.strip().splitlines() if l.strip()]
    return stamp({
        "event": "bench",
        "metric": "driver_bench",
        "value": None,
        "unit": "FAILED",
        "error": err_lines[-1][-300:] if err_lines else "no output",
        **extra,
        "source": source,
    })


def lift_file(path: str) -> List[dict]:
    """Lift one input file: a driver capture, a single bench record,
    or a JSONL of bench records."""
    source = os.path.basename(path)
    with open(path) as f:
        text = f.read()
    out: List[dict] = []
    try:
        data = json.loads(text)
    except ValueError:
        data = None
    if isinstance(data, dict):
        if "tail" in data or "parsed" in data:
            out.append(lift_capture(data, source))
        elif "metric" in data and "value" in data:
            out.append(_lift_record(data, source, {}))
        else:
            raise ValueError(
                f"{path}: neither a driver capture nor a bench record"
            )
    else:
        # JSONL of bench rows (BENCH_EXTRA.jsonl style).
        for lineno, line in enumerate(text.splitlines(), start=1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: not JSON ({e})")
            if not isinstance(row, dict) or "metric" not in row:
                raise ValueError(
                    f"{path}:{lineno}: not a bench record"
                )
            out.append(_lift_record(row, source, {}))
    for rec in out:
        validate_record(rec)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu_hpc_torch.obs.bank",
        description=__doc__.split("\n")[0],
    )
    ap.add_argument(
        "inputs", nargs="+",
        help="driver captures (BENCH_rNN.json), bench records, or "
        "bench-row JSONLs",
    )
    ap.add_argument(
        "-o", "--out", default="BENCH_HISTORY.jsonl",
        help="output JSONL (default BENCH_HISTORY.jsonl)",
    )
    args = ap.parse_args(argv)
    records: List[dict] = []
    for path in args.inputs:
        try:
            records.extend(lift_file(path))
        except (OSError, ValueError) as e:
            print(f"tpu_hpc_torch.obs.bank: {e}", file=sys.stderr)
            return 2
    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(
        f"tpu_hpc_torch.obs.bank: wrote {len(records)} validated bench "
        f"record(s) to {args.out}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
