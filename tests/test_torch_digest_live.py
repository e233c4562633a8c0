"""The port's live telemetry plane against the JAX package's: the digest
publisher and readers (``obs/digest.py``), the fleet rollup
(``obs/live.py``), and its two producers and one consumer in the port --
the Trainer's per-host digests and the supervisor's between-attempt
scoreboard.

  * the same publishes through both packages' ``DigestPublisher`` give
    equal channel records (but for run ids, hosts, pids and wall times);
  * ``read_digest_dir`` and ``merge_digest_hists`` agree over one
    directory of channels;
  * ``Rollup(...).build()``, ``format_scoreboard``, ``stale_entries``,
    ``fleet_prometheus_text`` and the ``--json`` / ``--prom`` outputs of
    ``python -m ... obs.live`` are equal over the same directory;
  * the port's Trainer publishes one ``role=host`` digest per chunk when
    ``TPU_HPC_DIGEST_DIR`` is set and nothing when it is not;
  * the port's supervisor prints the scoreboard and writes one
    ``digest_stale`` record per stale publisher after every attempt, as
    the JAX supervisor does.
"""
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax", reason="the JAX reference package")

from tpu_hpc import obs as jobs  # noqa: E402
from tpu_hpc.obs import digest as jdigest  # noqa: E402
from tpu_hpc.obs import live as jlive  # noqa: E402
from tpu_hpc.resilience import supervisor as jsupervisor  # noqa: E402
from tpu_hpc_torch import obs as tobs  # noqa: E402
from tpu_hpc_torch.obs import digest as tdigest  # noqa: E402
from tpu_hpc_torch.obs import live as tlive  # noqa: E402
from tpu_hpc_torch.resilience import supervisor as tsupervisor  # noqa: E402

PACKAGES = {"jax": (jobs, jdigest, jlive), "port": (tobs, tdigest, tlive)}
PROVENANCE = ("time", "run_id", "host", "pid")


def _strip(records):
    return [{k: v for k, v in r.items() if k not in PROVENANCE}
            for r in records]


def _publish_fleet(pkg, root):
    """A small fleet under ``root``: three hosts (one a straggler, one
    gone silent), four stages, two replicas; registry digests for the
    hosts, explicit payloads for the rest. Returns the host records."""
    obs, digest, _ = PACKAGES[pkg]
    rng = np.random.default_rng(0)
    bus = obs.EventBus(path=None, flight_dir="")
    recs = []
    for h in range(3):
        reg = obs.MetricsRegistry()
        pub = digest.DigestPublisher(root, "host", str(h), bus=bus)
        last = 4 if h < 2 else 1  # host 2 stops publishing early
        for step in range(1, last + 1):
            reg.inc("train_steps_total", 1)
            reg.set_gauge("train_step", step)
            for v in rng.gamma(2.0, 0.05 * (3 if h == 1 else 1), 8):
                reg.observe("train_step_s", float(v))
            recs.append(pub.publish_registry(
                reg, t=10.0 * step, step=step,
                step_s=0.1 * (3 if h == 1 else 1) + 0.001 * step,
                watermark_s=0.1 * (3 if h == 1 else 1)))
    for kind, n in (("stage", 4), ("replica", 2)):
        for k in range(n):
            pub = digest.DigestPublisher(root, kind, str(k), bus=bus,
                                         period_s=5.0)
            sk = digest.LogBucketSketch()
            for step in range(3):
                for v in rng.lognormal(0.0, 0.5, 16):
                    sk.add(float(v) * (1 + k))
                pub.publish(counters={"steps": float(step + 1),
                                      "requests": 7.0 * step},
                            gauges={"bubble_fraction": 0.25 + 0.01 * k,
                                    "kv_util": 0.5},
                            hists={"stage_busy_ms": sk},
                            t=5.0 * step + k, step_s=1.0 + k * 0.5,
                            step=step)
    return recs


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleets")
    out = {}
    for pkg in PACKAGES:
        d = str(root / pkg)
        out[pkg] = (d, _publish_fleet(pkg, d))
    return out


def test_publishes_give_equal_channel_records(fleets):
    (jdir, jrecs), (tdir, trecs) = fleets["jax"], fleets["port"]
    assert _strip(trecs) == _strip(jrecs)
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) and len(names) == 9
    for name in names:
        assert _strip(tdigest.read_channel(os.path.join(tdir, name))) == \
            _strip(jdigest.read_channel(os.path.join(jdir, name)))


def test_readers_and_merge_agree(fleets):
    (jdir, _), (tdir, _) = fleets["jax"], fleets["port"]
    jrecs = jdigest.read_digest_dir(jdir)
    trecs = tdigest.read_digest_dir(tdir)
    assert _strip(trecs) == _strip(jrecs)
    # Each package reads the other's channels the same way too.
    assert _strip(tdigest.read_digest_dir(jdir)) == _strip(jrecs)
    jm = jdigest.merge_digest_hists(jrecs)
    tm = tdigest.merge_digest_hists(trecs)
    assert sorted(tm) == sorted(jm) == ["stage_busy_ms", "train_step_s"]
    for name in jm:
        assert tm[name].to_dict() == jm[name].to_dict()
        assert tm[name].quantile(0.95) == jm[name].quantile(0.95)
    assert tdigest.read_digest_dir(os.path.join(tdir, "missing")) == []


@pytest.mark.parametrize("now", [None, 40.0, 80.0])
def test_rollup_views_equal(fleets, now):
    (jdir, _), (tdir, _) = fleets["jax"], fleets["port"]
    kw = dict(stale_after_s=15.0, straggler_factor=2.0)
    jview = jlive.rollup_from_dir(jdir, **kw).build(now=now)
    tview = tlive.rollup_from_dir(tdir, **kw).build(now=now)
    assert tview == jview
    assert tlive.format_scoreboard(tview) == jlive.format_scoreboard(jview)
    assert tlive.stale_entries(tview) == jlive.stale_entries(jview)
    assert tlive.fleet_prometheus_text(tview) == \
        jlive.fleet_prometheus_text(jview)
    if now == 40.0:
        assert [e["key"] for e in tlive.stale_entries(tview)
                if e["role"] == "host"] == ["2"]
        assert tview["roles"]["host"]["stragglers"] == ["1"]


def test_live_cli_outputs_equal(fleets, tmp_path):
    (jdir, _), (tdir, _) = fleets["jax"], fleets["port"]
    outs = {}
    for pkg, d, main in (("jax", jdir, jlive.main),
                         ("port", tdir, tlive.main)):
        prom = str(tmp_path / f"{pkg}.prom")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([d, "--json", "--now", "45", "--stale-after", "15",
                       "--straggler-factor", "2", "--prom", prom])
        assert rc == 0
        with open(prom) as f:
            outs[pkg] = (buf.getvalue(), f.read())
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["port"][0])["sources"] == 9
    with contextlib.redirect_stderr(io.StringIO()):
        assert tlive.main([str(tmp_path / "empty")]) == 2


def test_trainer_publishes_host_digests_only_when_armed(tmp_path,
                                                        monkeypatch):
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

    cfg = bench_model_cfg(16, dim=32, n_layers=1, n_heads=2, vocab_size=64,
                          multiple_of=16)
    digests = tmp_path / "digests"
    for armed in (False, True):
        if armed:
            monkeypatch.setenv(tobs.ENV_DIGEST_DIR, str(digests))
        else:
            monkeypatch.delenv(tobs.ENV_DIGEST_DIR, raising=False)
        trainer, ds = build_trainer(cfg, steps=2, epochs=2, batch=2,
                                    grad_accum_steps=1, device="cpu")
        assert (trainer.digest is not None) == armed
        trainer.fit(ds)
    recs = tdigest.read_digest_dir(str(digests))
    # One publish per chunk boundary (an epoch here), from this host.
    assert [(r["role"], r["key"], r["step"], r["seq"]) for r in recs] == \
        [("host", "0", 2, 0), ("host", "0", 4, 1)]
    assert recs[-1]["counters"]["train_steps_total"] >= 4
    assert "train_step_s" in recs[-1]["hists"]
    assert recs[-1]["step_s"] > 0  # the stall detector's signal
    view = tlive.rollup_from_dir(str(digests)).build()
    assert view["sources"] == 1


def _supervise(pkg, tmp_path, digest_dir):
    """One supervisor run of a child that fails its first attempt; the
    digest directory is set for the supervisor. Returns (stderr lines
    the supervisor printed about the fleet, digest_stale records)."""
    sup_mod = jsupervisor if pkg == "jax" else tsupervisor
    child = ("import os, sys; "
             "sys.exit(1 if os.environ['TPU_HPC_ATTEMPT'] == '0' else 0)")
    log_dir = str(tmp_path / f"sup_{pkg}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = sup_mod.Supervisor([sys.executable, "-c", child],
                                max_restarts=1, backoff=0.0,
                                log_dir=log_dir).run()
    assert rc == 0
    with open(os.path.join(log_dir, "supervisor.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    stale = [{k: v for k, v in r.items() if k not in PROVENANCE}
             for r in recs if r["event"] == "digest_stale"]
    # The scoreboard's lines (its event records print as JSON).
    lines = [ln for ln in err.getvalue().splitlines()
             if ln.startswith("supervisor: ")
             and not ln.startswith("supervisor: {")]
    return lines, stale


def test_supervisor_surfaces_the_rollup_between_attempts(fleets, tmp_path,
                                                         monkeypatch):
    got = {}
    for pkg in PACKAGES:
        monkeypatch.setenv(tobs.ENV_DIGEST_DIR, fleets[pkg][0])
        got[pkg] = _supervise(pkg, tmp_path, fleets[pkg][0])
    assert got["port"] == got["jax"]
    lines, stale = got["port"]
    assert any("host" in ln for ln in lines)
    # host 2 went silent: one record per attempt, attempts 0 and 1
    assert [(r["attempt"], r["key"]) for r in stale
            if r["role"] == "host"] == [(0, "2"), (1, "2")]
    # Unarmed: nothing surfaces, and a broken directory never raises.
    monkeypatch.delenv(tobs.ENV_DIGEST_DIR)
    assert _supervise("port", tmp_path / "off", None) == ([], [])
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "digest.host.0.pid1.jsonl").write_text("not json\n")
    monkeypatch.setenv(tobs.ENV_DIGEST_DIR, str(bad))
    assert _supervise("port", tmp_path / "broken", None) == ([], [])
