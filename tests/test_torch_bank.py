"""The port's bench-history converter against the JAX package's.

``tpu_hpc_torch.obs.bank`` is a framework-free copy of
``tpu_hpc.obs.bank``: every bench capture and row file of the repo
lifts to the same JSONL byte for byte (the wall-clock ``time`` stamp
pinned on both sides), the CLIs write the same file, and the port's
``regress --bank`` reads the lifted history to the JAX gate's verdict.
"""
import glob
import json
import os
import time

import pytest

pytest.importorskip("jax", reason="the JAX reference package")

from tpu_hpc.obs import bank as jbank
from tpu_hpc.obs import regress as jregress
from tpu_hpc_torch.obs import bank as tbank
from tpu_hpc_torch.obs import regress as tregress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTURES = sorted(glob.glob(os.path.join(REPO, "BENCH_r0*.json")))
ROW_FILES = [os.path.join(REPO, name) for name in (
    "BENCH_EXTRA.jsonl", "BENCH_PAGED_r08.jsonl", "BENCH_PREOUTAGE_r02.json",
    "HW_QUEUE_r05/bench_headline.json",
)]
T_PIN = 1_700_000_000.25


@pytest.fixture()
def pinned_time(monkeypatch):
    """``stamp`` fills ``time`` from the wall clock; one value for both
    packages makes their output comparable byte for byte."""
    monkeypatch.setattr(time, "time", lambda: T_PIN)


def _lines(mod, path):
    return [json.dumps(rec) for rec in mod.lift_file(path)]


@pytest.mark.parametrize(
    "path", CAPTURES + ROW_FILES,
    ids=[os.path.relpath(p, REPO) for p in CAPTURES + ROW_FILES])
def test_lift_file_matches_jax_byte_for_byte(path, pinned_time):
    got = _lines(tbank, path)
    assert got and got == _lines(jbank, path)


def test_captures_are_in_the_repo():
    assert len(CAPTURES) >= 5


def test_lift_capture_matches_jax(pinned_time):
    ok = {"n": 1, "cmd": "python bench.py", "rc": 0,
          "tail": "llama bench | MFU 46.3% (peak)",
          "parsed": {"metric": "m", "value": 10.0, "unit": "tok/s"}}
    failed = {"n": 2, "cmd": "python bench.py", "rc": 3,
              "tail": "probe failed\nbackend down", "parsed": None}
    for cap in (ok, failed):
        assert tbank.lift_capture(cap, "BENCH_r01.json") == \
            jbank.lift_capture(cap, "BENCH_r01.json")
    rec = tbank.lift_capture(failed, "x")
    assert (rec["value"], rec["unit"], rec["error"]) == (
        None, "FAILED", "backend down")


def _bank(mod, out, capsys):
    rc = mod.main([*CAPTURES, os.path.join(REPO, "BENCH_EXTRA.jsonl"),
                   "-o", str(out)])
    capsys.readouterr()
    return rc, out.read_bytes()


def test_cli_writes_the_jax_history(tmp_path, capsys, pinned_time):
    got = _bank(tbank, tmp_path / "port.jsonl", capsys)
    want = _bank(jbank, tmp_path / "jax.jsonl", capsys)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]


@pytest.mark.parametrize("bad", [{"whatever": 1}, "not json\n{}"],
                         ids=["not_a_record", "not_jsonl"])
def test_cli_rejects_garbage_like_jax(bad, tmp_path, capsys):
    path = tmp_path / "junk.json"
    path.write_text(bad if isinstance(bad, str) else json.dumps(bad))
    rcs = [mod.main([str(path), "-o", str(tmp_path / "o.jsonl")])
           for mod in (tbank, jbank)]
    capsys.readouterr()
    assert rcs == [2, 2]
    with pytest.raises(ValueError) as got:
        tbank.lift_file(str(path))
    with pytest.raises(ValueError) as want:
        jbank.lift_file(str(path))
    assert str(got.value) == str(want.value)


def _slowed(src, dst):
    """The history's successful rows at half their value (every banked
    headline here is a rate, higher-is-better): a regression."""
    rows = []
    for line in src.read_text().splitlines():
        rec = json.loads(line)
        if rec.get("value") is not None:
            rec["value"] = rec["value"] / 2
        rows.append(json.dumps(rec))
    dst.write_text("\n".join(rows) + "\n")


def test_regress_bank_reads_it_to_the_jax_verdict(tmp_path, capsys,
                                                  pinned_time):
    hist = tmp_path / "hist.jsonl"
    assert tbank.main([*CAPTURES, "-o", str(hist)]) == 0
    slow = tmp_path / "slow.jsonl"
    _slowed(hist, slow)
    capsys.readouterr()
    verdicts = {}
    for name, mod in (("port", tregress), ("jax", jregress)):
        verdicts[name] = []
        for cand in (hist, slow):
            rc = mod.main(["--bank", str(hist), str(cand)])
            verdicts[name].append((rc, capsys.readouterr().out))
    assert [rc for rc, _ in verdicts["port"]] == [0, 1]
    assert verdicts["port"] == verdicts["jax"]
