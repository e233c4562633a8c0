"""Numeric-health guard: detect poisoned steps, skip or roll back.

The process-level resilience story (signals/supervisor/faults) handles
a run that DIES; nothing before this module defended a run that keeps
stepping while its numerics are garbage. A single non-finite gradient
-- a corrupt batch, an SDC on a chip, fp overflow at a loss spike --
poisons the params within one optimizer update, and every subsequent
step (and checkpoint) is wasted work. The loss-spike/rewind discipline
of large-scale LLM training (the DDP/FSDP characterization study in
PAPERS.md; the SDC sections of "Collective Communication for 100k+
GPUs") is detection-plus-rollback; this module is that discipline as
config:

* the trainer's training step computes a tiny fused **health vector**
  per update -- loss finiteness, global grad norm, update norm,
  nonfinite-leaf count (``HEALTH_KEYS``) -- riding the existing
  stacked chunk metrics, so detection costs no extra device round
  trips and no recompiles;
* the host-side :class:`GuardPolicy` classifies every step
  ``healthy`` / ``spike`` / ``poisoned`` against a rolling median of
  recent healthy grad norms, at the chunk boundary where the trainer
  already fetches metrics;
* actions (``TrainingConfig.guard_mode``): ``skip`` drops the
  poisoned update on-device (params/opt-state/model-state keep their
  pre-step values; the step counter -- and with it the data stream --
  still advances), ``rollback`` quarantines any poisoned snapshots,
  records a **skip window** over the poisoned data indices, and exits
  with :data:`~tpu_hpc.resilience.signals.EXIT_ROLLBACK` so the
  supervisor relaunches from the last-good checkpoint -- through the
  ordinary restore path, so rollback works unchanged across an
  elastic pod-shape change (tpu_hpc.reshard handles the move).

Skip windows persist in ``<ckpt_dir>/.tpu_hpc_guard.json``: after the
rollback relaunch the loader fast-forwards past the poisoned batches
(``data_index = step + offset``), so the stream never replays the
batch that poisoned the run. Every decision is a schema-stamped obs
event (``guard_verdict`` / ``guard_rollback``) feeding
``obs.report``'s guard section and the ``regress`` gate's
lower-is-better rollback/skip counters.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import statistics
from typing import Deque, Dict, List, Optional, Sequence

# Metric keys the training step emits when the guard is armed (see
# train.trainer.make_step_fn). ``health_skipped`` only exists in skip
# mode; the rest are unconditional with the guard on.
HEALTH_KEYS = (
    "health_loss_finite",
    "health_grad_norm",
    "health_update_norm",
    "health_nonfinite",
    "health_skipped",
)

GUARD_STATE_FILE = ".tpu_hpc_guard.json"
GUARD_STATE_VERSION = 1

GUARD_MODES = ("off", "skip", "rollback")
SPIKE_ACTIONS = ("event", "rollback")


class GuardError(RuntimeError):
    """The guard needed to act but could not (e.g. rollback requested
    with no checkpoint predating the anomaly)."""


@dataclasses.dataclass(frozen=True)
class StepVerdict:
    """One step's classification, host-side."""

    step: int
    verdict: str  # "healthy" | "spike" | "poisoned"
    grad_norm: float
    update_norm: float
    loss_finite: bool
    nonfinite: int
    watermark: Optional[float] = None
    ratio: Optional[float] = None
    skipped: bool = False

    @property
    def healthy(self) -> bool:
        return self.verdict == "healthy"


class GuardPolicy:
    """Rolling-median classifier over per-step health vectors.

    ``spike_factor``: a finite step whose grad norm exceeds
    ``spike_factor x median(recent healthy grad norms)`` is a
    ``spike`` (0 disables spike detection). Only HEALTHY norms enter
    the window -- a diverging run must not re-baseline its own spikes
    into the median. ``min_samples`` healthy steps warm the median up
    before spikes can fire, so step 0's cold norm never false-alarms.
    """

    def __init__(
        self,
        mode: str = "skip",
        spike_factor: float = 10.0,
        spike_action: str = "event",
        window: int = 8,
        min_samples: int = 3,
    ):
        if mode not in GUARD_MODES[1:]:
            raise ValueError(
                f"guard mode {mode!r} must be one of {GUARD_MODES[1:]}"
                " (off = no policy object at all)"
            )
        if spike_factor < 0:
            raise ValueError(
                f"guard_spike_factor {spike_factor} must be >= 0 "
                "(0 = spike detection off)"
            )
        if spike_action not in SPIKE_ACTIONS:
            raise ValueError(
                f"guard_spike_action {spike_action!r} must be one of "
                f"{SPIKE_ACTIONS}"
            )
        if min_samples < 2:
            raise ValueError(
                f"min_samples {min_samples} must be >= 2"
            )
        if window < min_samples:
            raise ValueError(
                f"guard_window {window} must be >= min_samples "
                f"{min_samples}"
            )
        self.mode = mode
        self.spike_factor = spike_factor
        self.spike_action = spike_action
        self.window = window
        self.min_samples = min_samples
        self._norms: Deque[float] = collections.deque(maxlen=window)

    @classmethod
    def from_config(cls, cfg) -> Optional["GuardPolicy"]:
        """Build from a TrainingConfig; None when the guard is off.
        An unknown mode is rejected here, at trainer construction --
        a typo'd guard config must not train unguarded."""
        mode = getattr(cfg, "guard_mode", "off")
        if mode == "off":
            return None
        return cls(
            mode=mode,
            spike_factor=getattr(cfg, "guard_spike_factor", 10.0),
            spike_action=getattr(cfg, "guard_spike_action", "event"),
            window=getattr(cfg, "guard_window", 8),
        )

    @property
    def watermark(self) -> Optional[float]:
        """Median of the recent healthy grad norms; None until warm."""
        if len(self._norms) < self.min_samples:
            return None
        return statistics.median(self._norms)

    def classify(self, step: int, row: Dict[str, float]) -> StepVerdict:
        """Classify one step's health vector. Healthy steps feed the
        rolling median; anomalous ones never do."""
        loss_finite = bool(row.get("health_loss_finite", 1.0) >= 0.5)
        grad_norm = float(row.get("health_grad_norm", 0.0))
        update_norm = float(row.get("health_update_norm", 0.0))
        nonfinite = int(row.get("health_nonfinite", 0))
        skipped = bool(row.get("health_skipped", 0))
        watermark = self.watermark
        if (
            not loss_finite
            or nonfinite > 0
            or not math.isfinite(grad_norm)
            # Finite grads can still overflow the optimizer math
            # (bf16 Adam moments): a non-finite UPDATE is poison too.
            or not math.isfinite(update_norm)
        ):
            return StepVerdict(
                step, "poisoned", grad_norm, update_norm,
                loss_finite, nonfinite, watermark, None, skipped,
            )
        if (
            self.spike_factor > 0
            and watermark is not None
            and watermark > 0
            and grad_norm > self.spike_factor * watermark
        ):
            return StepVerdict(
                step, "spike", grad_norm, update_norm, loss_finite,
                nonfinite, watermark, grad_norm / watermark, skipped,
            )
        self._norms.append(grad_norm)
        return StepVerdict(
            step, "healthy", grad_norm, update_norm, loss_finite,
            nonfinite, watermark, None, skipped,
        )

    def wants_rollback(self, verdict: StepVerdict) -> bool:
        """Does this verdict, under this policy, demand a rollback?"""
        if verdict.verdict == "poisoned":
            return self.mode == "rollback"
        if verdict.verdict == "spike":
            return self.spike_action == "rollback"
        return False


# ---------------------------------------------------------------------
# skip windows: the persisted fast-forward state
# ---------------------------------------------------------------------
def _state_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, GUARD_STATE_FILE)


def load_state(ckpt_dir: Optional[str]) -> dict:
    """The guard's persisted state for a checkpoint directory:
    ``{"skip_windows": [...], "rollbacks": n}``. Empty-but-valid when
    the file is missing or unreadable (a lost guard file only costs
    the fast-forward -- the run still resumes)."""
    empty = {"skip_windows": [], "rollbacks": 0}
    if not ckpt_dir:
        return empty
    try:
        with open(_state_path(ckpt_dir)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return empty
    if not isinstance(data, dict):
        return empty
    data.setdefault("skip_windows", [])
    data.setdefault("rollbacks", 0)
    return data


def record_rollback(ckpt_dir: str, window: dict) -> dict:
    """Append one skip window atomically and bump the rollback count;
    returns the new state. ``window`` carries ``from_step`` (the first
    anomalous optimizer step) and ``data_from``/``data_to`` (the
    poisoned data-index span the stream must never replay)."""
    state = load_state(ckpt_dir)
    state["skip_windows"] = sorted(
        [*state["skip_windows"], dict(window)],
        key=lambda w: int(w["from_step"]),
    )
    state["rollbacks"] = int(state.get("rollbacks", 0)) + 1
    state["schema_version"] = GUARD_STATE_VERSION
    path = _state_path(ckpt_dir)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)
    return state


def window_width(window: dict) -> int:
    return int(window["data_to"]) - int(window["data_from"]) + 1


def offset_at(windows: Sequence[dict], step: int) -> int:
    """Cumulative data-stream offset at optimizer step ``step``:
    ``data_index = step + offset_at(...)``. Each window shifts every
    step at or past its ``from_step`` by the window's width, so the
    poisoned span of data indices is never consumed again while the
    pre-anomaly steps replay their original batches exactly."""
    return sum(
        window_width(w) for w in windows
        if step >= int(w["from_step"])
    )


def next_boundary(
    windows: Sequence[dict], step: int
) -> Optional[int]:
    """The next step at which the offset changes (the trainer caps
    its chunk there so one chunk never spans two offsets), or None."""
    future = [
        int(w["from_step"]) for w in windows
        if int(w["from_step"]) > step
    ]
    return min(future) if future else None


def health_rows(
    stacked: Dict[str, "object"], chunk: int
) -> List[Dict[str, float]]:
    """Split fetched per-chunk health arrays (numpy, shape [chunk])
    into one dict per step, in chunk order."""
    rows: List[Dict[str, float]] = []
    for i in range(chunk):
        rows.append({
            k: float(v[i]) for k, v in stacked.items()
        })
    return rows
