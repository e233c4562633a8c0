"""Topology-aware collective planner: measured cost tables + an
alpha-beta fallback.

Port of the JAX package's ``comm/planner.py``: the choice among the
gradient-sync strategies (flat / bucketed_overlap / hierarchical) and
the bucket size is the latency/bandwidth crossover NCCL's own tuner
encodes per (payload, algorithm, fabric), taken from *measured*
topology cost tables where there are some. Its consumer in the port is
the Trainer's gradient sync (``TrainingConfig.comm_mode="auto"``); the
chunk sizing (:meth:`Planner.chunk_bytes`) waits for its consumers, the
reshard engine and the disaggregated serving hop.

Mechanics (the JAX ones):

* **Topology fingerprint** -- the cache key: device kind, process
  count, node count (``n_slices``, the JAX field's name), and the
  canonical two-tier (dcn x ici) axis sizes from
  :func:`runtime.mesh.two_tier_spec`; a function of the *device set*,
  not of one mesh over it. For the same fields ``canonical()`` and
  ``digest`` equal the JAX package's.
* **Cost tables** -- measured (op, dtype) -> [(bytes, seconds)] curves
  from :mod:`tpu_hpc_torch.comm.bench` rows (``--emit-table`` writes a
  table directly), in the JAX package's on-disk JSON
  (``TABLE_VERSION`` 1) at ``<table_dir>/<digest>.json``
  (``$TPU_HPC_COMM_TABLES``, default ``~/.cache/tpu_hpc/comm_tables``);
  either package reads the other's tables. Lookups interpolate log-log
  between measured sizes. A corrupt or partial table file degrades to
  the analytic fallback with a warning.
* **Alpha-beta fallback** -- per-tier latency + bytes/bandwidth with
  the H100's fabric (below), so :func:`Planner.plan` always answers
  even with zero measurements, labeled ``source="model"``.

Every decision is a typed :class:`CommDecision` (mode, bucket bytes,
predicted cost, the candidates, and whether each number came from
measurement or model); the Trainer logs it as a schema-stamped
``comm_plan`` event, and ``python -m tpu_hpc_torch.comm.planner
--explain OP BYTES`` prints the same reasoning.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tpu_hpc_torch.logging_ import get_logger

ENV_TABLE_DIR = "TPU_HPC_COMM_TABLES"
TABLE_VERSION = 1

# -- the alpha-beta fabric model ---------------------------------------
# Per-tier (launch latency s, bandwidth B/s) of an H100 SXM job; the
# tier keys keep the JAX names: "ici" is the inside of a node, "dcn" the
# network between nodes. The bandwidths are the card table's
# (checks/roofline.py, row "h100-sxm": SPEC-SHEET figures, not
# measurements -- NVLink 4 a direction, one 400 Gb/s NIC a card), the
# one table the roofline estimator reads too. The launch latencies are
# order-of-magnitude assumptions (a few us for an NVLink collective,
# tens of us across nodes), not read from any card. The planner's
# *decisions* rest on the asymmetry (alpha_dcn > alpha_ici, bw_dcn <
# bw_ici), which gives NCCL's crossover shape: flat wins small payloads
# (one launch), hierarchical wins large ones (1/n_ici of the bytes cross
# nodes). A measured table (comm.bench --emit-table) overrides all of
# this per topology.
def _tier_model() -> Dict[str, Tuple[float, float]]:
    from tpu_hpc_torch.checks.roofline import CHIPS

    card = CHIPS["h100-sxm"]
    return {"ici": (5e-6, card.ici_gbps * 1e9),
            "dcn": (2e-5, card.dcn_gbps * 1e9)}


TIER_MODEL: Dict[str, Tuple[float, float]] = _tier_model()

# Fraction of a bucket pipeline's collective time the latency-hiding
# scheduler is modeled to hide behind backward compute (buckets after
# the first overlap with the remaining differentiation). One bucket =
# nothing to pipeline = no benefit, so tiny payloads tie with flat and
# the deterministic tie-break below keeps them flat.
OVERLAP_HIDE = 0.5

# Bucket candidates the grad-sync planner chooses among (bytes). The
# config cap (comm_bucket_mb) bounds the ladder from above.
BUCKET_LADDER = tuple(
    int(b * 2 ** 20)
    for b in (0.0625, 0.25, 1, 4, 8, 16, 25, 32, 64)
)

# A chunked move's per-chunk bytes should dwarf the launch latency:
# chunk >= AMORTIZE * alpha * bw makes the alpha overhead <= 1/AMORTIZE
# of each chunk's wire time.
CHUNK_AMORTIZE = 8.0

# Flat ops the analytic model prices over the whole device set. Their
# per-device wire factors are single-sourced from
# comm.bench.wire_factor (the NCCL-tests busbw table); "transfer" is
# one full-payload hop and "exchange" rides the all_to_all factor.
_FLAT_OPS = (
    "broadcast", "all_reduce", "all_gather", "reduce_scatter",
    "all_to_all", "ring_shift", "transfer", "exchange",
)

# Hierarchical variant of each flat collective (the candidate pairing
# plan() evaluates), and the per-phase launch counts of each
# decomposition (comm.hierarchical: all-reduce = ICI RS + DCN AR + ICI
# AG; the gather/scatter variants run one phase per tier).
_HIER_OF = {
    "all_reduce": "hier_all_reduce",
    "all_gather": "hier_all_gather",
    "reduce_scatter": "hier_reduce_scatter",
}
_HIER_LAUNCHES = {
    "hier_all_reduce": (2, 1),
    "hier_all_gather": (1, 1),
    "hier_reduce_scatter": (1, 1),
}


class CostTableError(ValueError):
    """A cost-table file is corrupt, partial, or mis-keyed."""


# -- topology fingerprint ----------------------------------------------
@dataclasses.dataclass(frozen=True)
class TopologyFingerprint:
    """The cost-table cache key: what the fabric looks like, canonical
    across process restarts and across meshes built over the same
    device set."""

    device_kind: str
    platform: str
    n_devices: int
    n_processes: int
    n_slices: int
    axes: Tuple[Tuple[str, int], ...]
    tiers: Tuple[Tuple[str, str], ...]

    def canonical(self) -> dict:
        return {
            "device_kind": self.device_kind,
            "platform": self.platform,
            "n_devices": self.n_devices,
            "n_processes": self.n_processes,
            "n_slices": self.n_slices,
            "axes": dict(self.axes),
            "tiers": dict(self.tiers),
        }

    @property
    def digest(self) -> str:
        blob = json.dumps(self.canonical(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    @property
    def two_tier(self) -> bool:
        """Does the canonical layout expose both fabric tiers?"""
        return any(t == "dcn" for _, t in self.tiers)

    def tier_sizes(self) -> Tuple[int, int]:
        """(n_dcn, n_ici) of the canonical layout; (1, n) when flat."""
        axes = dict(self.axes)
        tiers = dict(self.tiers)
        n_dcn = math.prod(
            v for k, v in axes.items() if tiers.get(k) == "dcn"
        ) if self.two_tier else 1
        n_ici = max(1, self.n_devices // max(n_dcn, 1))
        return n_dcn, n_ici

    def describe(self) -> str:
        axes = ",".join(f"{k}={v}" for k, v in self.axes)
        return (
            f"{self.digest} ({self.device_kind} x{self.n_devices}, "
            f"{self.n_slices} slice(s), axes {axes})"
        )


def make_fingerprint(device_kind: str, platform: str, n_devices: int,
                     n_processes: int, n_slices: int) -> TopologyFingerprint:
    """The fingerprint of a device set from its fields: the canonical
    (dcn x ici) axis sizes from :func:`runtime.mesh.two_tier_spec` (the
    one construction policy everything hierarchical routes through),
    or a flat ``{data: n}`` axis where it refuses; the dcn axis earns
    the "dcn" tier only across more than one node -- an emulated dcn
    axis on one node is NVLink and is costed as such. The JAX
    ``fingerprint_devices``'s rule, so equal fields give equal
    digests."""
    from tpu_hpc_torch.runtime.mesh import two_tier_spec

    try:
        spec = two_tier_spec(n_devices, n_slices)
        axes = tuple(spec.resolved_sizes(n_devices).items())
    except ValueError:
        axes = (("data", n_devices),)
    tiers = tuple(
        (name, "dcn" if name == "dcn" and n_slices > 1 else "ici")
        for name, _ in axes
    )
    return TopologyFingerprint(
        device_kind=device_kind, platform=platform, n_devices=n_devices,
        n_processes=n_processes, n_slices=n_slices, axes=axes, tiers=tiers,
    )


def _device_fields(device_type: Optional[str]) -> Tuple[str, str]:
    """(device_kind, platform) as JAX names them: the card's name and
    "gpu" on CUDA, "cpu" and "cpu" on the CPU."""
    import torch

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device_type).type == "cuda":
        return torch.cuda.get_device_name(), "gpu"
    return "cpu", "cpu"


def fingerprint_devices(
    slices: Optional[int] = None,
    device_type: Optional[str] = None,
    n_devices: Optional[int] = None,
) -> TopologyFingerprint:
    """Fingerprint the job's device set: one card a process, so the
    world size is both the device and the process count; the node count
    from :func:`runtime.mesh.node_groups` (``slices`` overrides it, to
    plan for a modeled topology); ``device_type`` defaults to cuda when
    a card is visible. ``n_devices`` fingerprints a set of that size
    instead of the world (a planning question, no process group
    needed)."""
    import torch.distributed as dist

    from tpu_hpc_torch.runtime.mesh import node_groups

    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
        n_processes = n_devices
    else:
        n_processes = n_devices
    n_slices = int(slices) if slices is not None else len(node_groups())
    kind, platform = _device_fields(device_type)
    return make_fingerprint(kind, platform, n_devices, n_processes,
                            n_slices)


def fingerprint_mesh(mesh) -> TopologyFingerprint:
    """Fingerprint of the device set under a ``DeviceMesh`` (NOT the
    mesh's own axis layout: the flat and hierarchical benchmarks over
    one job share a table); None is one device."""
    from tpu_hpc_torch.runtime.mesh import node_groups

    if mesh is None:
        return fingerprint_devices(n_devices=1, slices=1)
    ranks = set(mesh.mesh.flatten().tolist())
    nodes = sum(1 for g in node_groups() if ranks & set(g))
    return fingerprint_devices(slices=max(nodes, 1),
                               device_type=mesh.device_type,
                               n_devices=len(ranks))


# -- measured cost tables ----------------------------------------------
@dataclasses.dataclass
class CostTable:
    """Measured (op, dtype) -> [(bytes, seconds)] curves for one
    topology fingerprint."""

    fingerprint: dict
    digest: str
    entries: Dict[Tuple[str, str], List[Tuple[int, float]]] = (
        dataclasses.field(default_factory=dict)
    )
    path: Optional[str] = None

    def add(self, op: str, dtype: str, nbytes: int, mean_s: float) -> None:
        if nbytes <= 0 or mean_s <= 0:
            return
        curve = self.entries.setdefault((op, str(dtype)), [])
        curve.append((int(nbytes), float(mean_s)))
        curve.sort()

    def __len__(self) -> int:
        return sum(len(v) for v in self.entries.values())

    @property
    def ops(self) -> Tuple[str, ...]:
        return tuple(sorted({op for op, _ in self.entries}))

    def lookup(
        self, op: str, dtype: str, nbytes: int
    ) -> Optional[float]:
        """Interpolated measured cost, or None when the table has no
        curve for (op, dtype). Interpolation is log-log between the
        bracketing measured sizes (collective time over payload decades
        is near-linear in that space); beyond the measured range the
        end segment's slope extrapolates -- labeled measured because
        the slope is."""
        curve = self.entries.get((op, str(dtype)))
        if not curve:
            return None
        if len(curve) == 1:
            # One point: scale by the bandwidth term it implies.
            b0, t0 = curve[0]
            return t0 * max(nbytes, 1) / b0
        pts = [(math.log(b), math.log(t)) for b, t in curve]
        x = math.log(max(nbytes, 1))
        if x <= pts[0][0]:
            (x0, y0), (x1, y1) = pts[0], pts[1]
        elif x >= pts[-1][0]:
            (x0, y0), (x1, y1) = pts[-2], pts[-1]
        else:
            for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
                if x0 <= x <= x1:
                    break
        if x1 == x0:
            return math.exp(y0)
        y = y0 + (y1 - y0) * (x - x0) / (x1 - x0)
        return math.exp(y)

    # -- (de)serialization --------------------------------------------
    def to_json(self) -> dict:
        return {
            "table_version": TABLE_VERSION,
            "fingerprint": self.fingerprint,
            "digest": self.digest,
            "entries": [
                {"op": op, "dtype": dt, "bytes": b, "mean_s": t}
                for (op, dt), curve in sorted(self.entries.items())
                for b, t in curve
            ],
        }

    @classmethod
    def from_json(cls, data: Any, path: Optional[str] = None) -> "CostTable":
        if not isinstance(data, dict):
            raise CostTableError(
                f"cost table must be a JSON object, got "
                f"{type(data).__name__}"
            )
        if data.get("table_version") != TABLE_VERSION:
            raise CostTableError(
                f"table_version {data.get('table_version')!r} != "
                f"{TABLE_VERSION}"
            )
        for field in ("fingerprint", "digest", "entries"):
            if field not in data:
                raise CostTableError(f"cost table missing {field!r}")
        table = cls(
            fingerprint=data["fingerprint"], digest=data["digest"],
            path=path,
        )
        for i, e in enumerate(data["entries"]):
            try:
                table.add(e["op"], e["dtype"], e["bytes"], e["mean_s"])
            except (TypeError, KeyError) as err:
                raise CostTableError(
                    f"entry {i} malformed: {err!r}"
                ) from None
        return table

    def save(self, path: str) -> str:
        """Write the table (atomic; a crash mid-write must not leave a
        torn table the loader would then warn about forever). Any path
        not ending in ``.json`` is treated as a directory (created if
        needed) and gets ``<digest>.json`` inside it -- the cache
        layout :func:`load_cached` reads."""
        if not path.endswith(".json"):
            path = os.path.join(path, f"{self.digest}.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        os.replace(tmp, path)
        self.path = path
        return path

    @classmethod
    def from_rows(
        cls,
        rows: Sequence[dict],
        fingerprint: Optional[TopologyFingerprint] = None,
    ) -> "CostTable":
        """Build a table from comm-bench records (each row carries
        ``op``/``dtype``/``bytes_per_shard``/``mean_s`` and its
        ``fingerprint`` digest). Rows whose digest disagrees with the
        majority (or with ``fingerprint`` when given) are rejected --
        a table silently mixing topologies would be worse than none.
        """
        usable = [
            r for r in rows
            if r.get("op") and r.get("bytes_per_shard")
            and r.get("mean_s") and r.get("fingerprint")
        ]
        if not usable:
            raise CostTableError(
                "no bench rows carry (op, bytes_per_shard, mean_s, "
                "fingerprint) -- re-run tpu_hpc_torch.comm.bench to emit "
                "planner-keyed rows"
            )
        digests = {r["fingerprint"] for r in usable}
        if fingerprint is not None:
            digest, canon = fingerprint.digest, fingerprint.canonical()
        elif len(digests) == 1:
            digest = digests.pop()
            canon = usable[0].get("fingerprint_topology") or {}
        else:
            raise CostTableError(
                f"rows span {len(digests)} fingerprints "
                f"({sorted(digests)}); pass the one to keep"
            )
        table = cls(fingerprint=canon, digest=digest)
        for r in usable:
            if r["fingerprint"] != digest:
                continue
            table.add(
                r["op"], r.get("dtype", "float32"),
                r["bytes_per_shard"], r["mean_s"],
            )
        if not len(table):
            raise CostTableError(
                f"no rows matched fingerprint {digest}"
            )
        return table


def table_dir(override: Optional[str] = None) -> str:
    return (
        override
        or os.environ.get(ENV_TABLE_DIR)
        or os.path.join(
            os.path.expanduser("~"), ".cache", "tpu_hpc", "comm_tables"
        )
    )


def load_table(path: str) -> CostTable:
    """Load one table file; raises :class:`CostTableError` on corrupt
    or partial content."""
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError as e:
        raise CostTableError(f"{path}: {e}") from None
    except ValueError as e:
        raise CostTableError(f"{path}: not JSON ({e})") from None
    return CostTable.from_json(data, path=path)


def load_cached(
    fp: TopologyFingerprint, table_dir_: Optional[str] = None
) -> Optional[CostTable]:
    """The cached table for this topology, or None (absent, or corrupt
    -- the latter with a warning: the planner must degrade to the
    analytic fallback, never crash its consumer)."""
    path = os.path.join(table_dir(table_dir_), f"{fp.digest}.json")
    if not os.path.exists(path):
        return None
    try:
        return load_table(path)
    except CostTableError as e:
        get_logger("tpu_hpc_torch.comm.planner").warning(
            "ignoring corrupt cost table %s (%s); planner falls back "
            "to the alpha-beta model -- delete or re-emit the table",
            path, e,
        )
        return None


# -- analytic fallback -------------------------------------------------
def tier_cost(tier: str, nbytes: float) -> float:
    """alpha + bytes/bw for one launch over one tier. Strictly
    increasing in bytes; at equal bytes the DCN tier is strictly
    costlier than ICI (both pinned in tests)."""
    alpha, bw = TIER_MODEL[tier]
    return alpha + nbytes / bw


def model_cost(op: str, nbytes: int, fp: TopologyFingerprint) -> float:
    """Analytic cost of one ``op`` at per-shard payload ``nbytes`` on
    the fingerprinted topology. The bottleneck tier of a flat op is
    DCN whenever the device set spans slices (a flat collective ships
    its full wire share cross-slice); hierarchical ops split their
    bytes per phase exactly like :func:`comm.bench.two_phase_bytes`.
    """
    n = fp.n_devices
    if op in _FLAT_OPS:
        if n <= 1 and op not in ("transfer",):
            return 0.0
        tier = "dcn" if fp.n_slices > 1 else "ici"
        if op == "transfer":
            # Cross-mesh device_put: one hop of the full payload over
            # the slower fabric (disjoint tiers talk over DCN on real
            # pods; ICI when everything is one slice).
            return tier_cost(tier, nbytes)
        from tpu_hpc_torch.comm.bench import wire_factor

        key = "all_to_all" if op == "exchange" else op
        return tier_cost(tier, wire_factor(key, n) * nbytes)
    if op in _HIER_LAUNCHES:
        if not fp.two_tier:
            raise ValueError(
                f"{op} needs a two-tier topology; fingerprint "
                f"{fp.digest} is flat"
            )
        from tpu_hpc_torch.comm.bench import two_phase_bytes

        n_dcn, n_ici = fp.tier_sizes()
        ici_b, dcn_b = two_phase_bytes(op, nbytes, n_dcn, n_ici)
        l_ici, l_dcn = _HIER_LAUNCHES[op]
        a_ici, bw_ici = TIER_MODEL["ici"]
        a_dcn, bw_dcn = TIER_MODEL[
            "dcn" if fp.n_slices > 1 else "ici"
        ]
        return (
            l_ici * a_ici + ici_b / bw_ici
            + l_dcn * a_dcn + dcn_b / bw_dcn
        )
    raise ValueError(f"unknown op {op!r} for the analytic model")


# -- decisions ---------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CommDecision:
    """A planner verdict: what to run and why. ``source`` says where
    the winning number came from -- "measured" (cost table),
    "model" (alpha-beta fallback) or "constraint" (only one legal
    choice, no cost comparison ran)."""

    op: str
    payload_bytes: int
    dtype: str
    mode: str
    bucket_bytes: Optional[int]
    predicted_cost_s: float
    source: str
    fingerprint: str
    table: Optional[str]
    candidates: Tuple[Dict[str, Any], ...]
    reason: str = ""

    def summary(self) -> dict:
        """JSON-safe decision record -- the ``comm_plan`` obs event
        payload."""
        rec = {
            "op": self.op,
            "mode": self.mode,
            "source": self.source,
            "payload_bytes": int(self.payload_bytes),
            "dtype": self.dtype,
            "predicted_cost_ms": round(self.predicted_cost_s * 1e3, 6),
            "fingerprint": self.fingerprint,
            "candidates": [dict(c) for c in self.candidates],
        }
        if self.bucket_bytes is not None:
            rec["bucket_bytes"] = int(self.bucket_bytes)
        if self.table:
            rec["table"] = self.table
        if self.reason:
            rec["reason"] = self.reason
        return rec

    def explain(self) -> str:
        lines = [
            f"decision: op={self.op} payload={self.payload_bytes} B "
            f"dtype={self.dtype} -> mode={self.mode}"
            + (
                f" bucket={self.bucket_bytes // 2 ** 10} KiB"
                if self.bucket_bytes else ""
            )
            + f" pred={self.predicted_cost_s * 1e3:.4f} ms "
            f"[{self.source}]",
        ]
        if self.reason:
            lines.append(f"  reason: {self.reason}")
        if self.candidates:
            lines.append("candidates:")
            for c in self.candidates:
                lines.append(
                    f"  {c['mode']:<18} "
                    f"{c['cost_ms']:>12.4f} ms  [{c['source']}]"
                )
        return "\n".join(lines)


@dataclasses.dataclass
class Planner:
    """Cost-table-driven collective planner for one topology."""

    fingerprint: TopologyFingerprint
    table: Optional[CostTable] = None

    @classmethod
    def for_devices(
        cls,
        slices: Optional[int] = None,
        table_dir: Optional[str] = None,
        table: Optional[CostTable] = None,
        device_type: Optional[str] = None,
        n_devices: Optional[int] = None,
    ) -> "Planner":
        fp = fingerprint_devices(slices=slices, device_type=device_type,
                                 n_devices=n_devices)
        if table is None:
            table = load_cached(fp, table_dir)
        return cls(fingerprint=fp, table=table)

    @classmethod
    def for_mesh(
        cls,
        mesh,
        table_dir: Optional[str] = None,
        table: Optional[CostTable] = None,
    ) -> "Planner":
        fp = fingerprint_mesh(mesh)
        if table is None:
            table = load_cached(fp, table_dir)
        return cls(fingerprint=fp, table=table)

    # -- cost resolution ----------------------------------------------
    def cost(
        self, op: str, nbytes: int, dtype: str = "float32"
    ) -> Tuple[float, str]:
        """(seconds, source): the measured curve when the table has
        one for (op, dtype), else the alpha-beta model."""
        if self.table is not None:
            t = self.table.lookup(op, dtype, nbytes)
            if t is not None:
                return t, "measured"
        return model_cost(op, nbytes, self.fingerprint), "model"

    # -- generic collective choice ------------------------------------
    def plan(
        self, op: str, nbytes: int, dtype: str = "float32"
    ) -> CommDecision:
        """Flat vs hierarchical for one collective at one payload.

        ``op`` is the flat collective name (comm.bench vocabulary);
        the hierarchical variant is a candidate whenever the topology
        exposes both tiers OR the table measured it (a sim-mesh table
        carries hier rows even though its fingerprint is one slice).
        """
        cands: List[Dict[str, Any]] = []
        c, src = self.cost(op, nbytes, dtype)
        cands.append({
            "mode": "flat", "cost_ms": round(c * 1e3, 6),
            "cost_s": c, "source": src,
        })
        hier = _HIER_OF.get(op)
        if hier is not None:
            measured = (
                self.table is not None
                and self.table.lookup(hier, dtype, nbytes) is not None
            )
            if measured or self.fingerprint.two_tier:
                hc, hsrc = self.cost(hier, nbytes, dtype)
                cands.append({
                    "mode": "hierarchical",
                    "cost_ms": round(hc * 1e3, 6),
                    "cost_s": hc, "source": hsrc,
                })
        best = min(cands, key=lambda c: c["cost_s"])  # ties: flat first
        return CommDecision(
            op=op, payload_bytes=nbytes, dtype=dtype,
            mode=best["mode"], bucket_bytes=None,
            predicted_cost_s=best["cost_s"], source=best["source"],
            fingerprint=self.fingerprint.digest,
            table=getattr(self.table, "path", None),
            candidates=tuple(
                {k: v for k, v in c.items() if k != "cost_s"}
                for c in cands
            ),
        )

    # -- gradient sync (the Trainer consumer) -------------------------
    def _bucketed_cost(
        self,
        op: str,
        payload: int,
        bucket: int,
        dtype: str,
    ) -> Tuple[float, str]:
        """Modeled pipeline cost of syncing ``payload`` bytes in
        ``bucket``-sized pieces: every bucket pays its own collective,
        but buckets after the first overlap with backward compute
        (OVERLAP_HIDE of their time hides)."""
        n_b = max(1, -(-payload // bucket))
        per, src = self.cost(op, min(bucket, payload), dtype)
        total = n_b * per
        hidden = OVERLAP_HIDE * (1.0 - 1.0 / n_b)
        return total * (1.0 - hidden), src

    def bucket_bytes_for(
        self,
        op: str,
        payload: int,
        dtype: str = "float32",
        cap: Optional[int] = None,
    ) -> int:
        """The bucket size minimizing the modeled pipeline cost over
        the ladder (capped by the config knob)."""
        cap = cap or BUCKET_LADDER[-1]
        ladder = sorted(
            {b for b in BUCKET_LADDER if b <= cap} | {cap}
        )
        best = min(
            ladder,
            key=lambda b: self._bucketed_cost(op, payload, b, dtype)[0],
        )
        return best

    def plan_grad_sync(
        self,
        payload_bytes: int,
        dtype: str = "float32",
        params_sharded: bool = False,
        two_tier: bool = False,
        bucket_cap_bytes: Optional[int] = None,
        constraint_reason: Optional[str] = None,
    ) -> CommDecision:
        """Choose the Trainer's gradient-sync mode + bucket size.

        ``params_sharded`` forces flat (FSDP/TP plans keep GSPMD's
        fused collectives -- fsdp.validate_grad_sync_mode's rule);
        ``constraint_reason`` forces flat for any OTHER structural
        reason, recorded verbatim (the comm_plan event exists so
        sweeps can attribute the planner's reasoning -- a wrong cause
        sends the operator to the wrong knob). ``two_tier`` admits
        the hierarchical candidate (the batch must shard over
        (dcn, ici) axes for it to be runnable at all). Ties break
        toward the earlier candidate -- flat beats a manual mode that
        merely matches it.
        """
        if params_sharded or constraint_reason is not None:
            c, src = self.cost("all_reduce", payload_bytes, dtype)
            return CommDecision(
                op="grad_sync", payload_bytes=payload_bytes,
                dtype=dtype, mode="flat", bucket_bytes=None,
                predicted_cost_s=c, source="constraint",
                fingerprint=self.fingerprint.digest,
                table=getattr(self.table, "path", None),
                candidates=({
                    "mode": "flat", "cost_ms": round(c * 1e3, 6),
                    "source": src,
                },),
                reason=(
                    "params are sharded (FSDP/TP): manual sync modes "
                    "need replicated params, GSPMD owns these "
                    "collectives"
                ) if params_sharded else constraint_reason,
            )
        cands: List[Dict[str, Any]] = []
        c, src = self.cost("all_reduce", payload_bytes, dtype)
        cands.append({
            "mode": "flat", "cost_ms": round(c * 1e3, 6),
            "cost_s": c, "source": src, "bucket_bytes": None,
        })
        bucket = self.bucket_bytes_for(
            "all_reduce", payload_bytes, dtype, cap=bucket_cap_bytes
        )
        bc, bsrc = self._bucketed_cost(
            "all_reduce", payload_bytes, bucket, dtype
        )
        cands.append({
            "mode": "bucketed_overlap", "cost_ms": round(bc * 1e3, 6),
            "cost_s": bc, "source": bsrc, "bucket_bytes": bucket,
        })
        hier_available = two_tier and (
            self.fingerprint.two_tier
            or (
                self.table is not None
                and self.table.lookup(
                    "hier_all_reduce", dtype, payload_bytes
                ) is not None
            )
        )
        if hier_available:
            hbucket = self.bucket_bytes_for(
                "hier_all_reduce", payload_bytes, dtype,
                cap=bucket_cap_bytes,
            )
            hc, hsrc = self._bucketed_cost(
                "hier_all_reduce", payload_bytes, hbucket, dtype
            )
            cands.append({
                "mode": "hierarchical", "cost_ms": round(hc * 1e3, 6),
                "cost_s": hc, "source": hsrc, "bucket_bytes": hbucket,
            })
        best = min(cands, key=lambda c: c["cost_s"])
        return CommDecision(
            op="grad_sync", payload_bytes=payload_bytes, dtype=dtype,
            mode=best["mode"], bucket_bytes=best["bucket_bytes"],
            predicted_cost_s=best["cost_s"], source=best["source"],
            fingerprint=self.fingerprint.digest,
            table=getattr(self.table, "path", None),
            candidates=tuple(
                {k: v for k, v in c.items() if k != "cost_s"}
                for c in cands
            ),
        )

    # -- chunk sizing (reshard + disagg consumers) --------------------
    def chunk_bytes(self, total_bytes: int) -> int:
        """Recommended per-chunk transient for a bounded move of
        ``total_bytes``: big enough that launch latency amortizes
        (chunk wire time >= CHUNK_AMORTIZE x alpha), no bigger than
        the move itself. The fabric tier follows the fingerprint --
        build the planner over exactly the devices the move touches
        (reshard does: the union of source and target meshes), and a
        device set spanning slices amortizes against the DCN alpha."""
        tier = "dcn" if self.fingerprint.n_slices > 1 else "ici"
        alpha, bw = TIER_MODEL[tier]
        floor = int(CHUNK_AMORTIZE * alpha * bw)
        # Round up to the next power of two: chunk counts stay stable
        # under small payload drift (stable chunk specs = stable
        # compiled-program cache keys in the reshard executor).
        chunk = 1 << max(floor - 1, 1).bit_length()
        return max(1, min(chunk, max(int(total_bytes), 1)))


# -- the Trainer hook --------------------------------------------------
def plan_trainer_grad_sync(
    mesh,
    batch_pspec,
    param_pspecs,
    params,
    bucket_cap_bytes: Optional[int] = None,
    table_dir: Optional[str] = None,
) -> CommDecision:
    """Resolve ``comm_mode="auto"`` for a Trainer: inspects the
    sharding plan (sharded params force flat), the batch pspec (two
    sync axes admit hierarchical), and the exact gradient payload, and
    asks the topology's planner. ``mesh`` None (one device, no process
    group) has no gradient sync to plan either: flat, by constraint.
    ``params``: the param tree (tensors or numpy arrays)."""
    from tpu_hpc_torch.comm import overlap
    from tpu_hpc_torch.parallel.plans import tree_specs
    from tpu_hpc_torch.train.trainer import tree_leaves

    sharded = any(
        any(entry is not None for entry in spec)
        for spec in tree_specs(param_pspecs)
    ) if param_pspecs is not None else False
    constraint = None
    try:
        sync_axes = overlap.sync_axes_from_batch_pspec(batch_pspec)
        if mesh is None:
            sync_axes = ()
            constraint = (
                "no process group (one device): there is no "
                "data-parallel gradient sync to plan"
            )
    except ValueError:
        # Nothing to sync over: keep GSPMD's program -- and say THAT,
        # not "params are sharded" (a false cause in the comm_plan
        # event would send the operator to the wrong knob).
        sync_axes = ()
        constraint = (
            "the batch pspec shards the batch over no mesh axis: "
            "there is no data-parallel gradient sync to plan"
        )
    leaves = tree_leaves(params)
    payload = sum(
        int(math.prod(leaf.shape)) * overlap._itemsize(leaf.dtype)
        for leaf in leaves
    )
    dtype = overlap._dtype_key(leaves[0].dtype) if leaves else "float32"
    planner = Planner.for_mesh(mesh, table_dir=table_dir)
    return planner.plan_grad_sync(
        payload, dtype=dtype, params_sharded=sharded,
        two_tier=len(sync_axes) == 2,
        bucket_cap_bytes=bucket_cap_bytes,
        constraint_reason=constraint,
    )


# -- cost-table inventory (the doctor line) ----------------------------
def table_inventory(
    table_dir_: Optional[str] = None,
    slices: Optional[int] = None,
    device_type: Optional[str] = None,
) -> dict:
    """What the planner would find for the live topology:
    ``status`` in {"measured", "stale", "absent"} plus the fingerprint
    and (when measured) entry/op counts -- the doctor's inventory
    line."""
    fp = fingerprint_devices(slices=slices, device_type=device_type)
    d = table_dir(table_dir_)
    others = []
    if os.path.isdir(d):
        others = [f for f in sorted(os.listdir(d))
                  if f.endswith(".json")]
    path = os.path.join(d, f"{fp.digest}.json")
    inv = {
        "fingerprint": fp.digest,
        "topology": fp.describe(),
        "table_dir": d,
        "n_tables": len(others),
    }
    if os.path.exists(path):
        table = load_cached(fp, table_dir_)
        if table is None:
            inv.update(status="stale", detail="corrupt table file")
        else:
            inv.update(
                status="measured", path=path, entries=len(table),
                ops=list(table.ops),
            )
    elif others:
        inv.update(status="stale")
    else:
        inv.update(status="absent")
    return inv


def format_inventory(inv: dict) -> str:
    s = inv["status"]
    head = f"comm cost tables: fingerprint {inv['topology']} -- "
    if s == "measured":
        return head + (
            f"measured table ({inv['entries']} entries: "
            f"{', '.join(inv['ops'])}) at {inv['path']}"
        )
    if s == "stale":
        return head + (
            f"stale ({inv['n_tables']} table(s) in {inv['table_dir']} "
            "for other topologies"
            + (
                " or corrupt" if inv.get("detail") else ""
            )
            + "); planner answers from the alpha-beta model -- "
            "re-measure with `python -m tpu_hpc_torch.comm.bench "
            "--emit-table " + inv["table_dir"] + "`"
        )
    return head + (
        "absent; planner answers from the alpha-beta model -- "
        "measure with `python -m tpu_hpc_torch.comm.bench --emit-table "
        + inv["table_dir"] + "`"
    )


# -- CLI ---------------------------------------------------------------
def _sweep_rows(
    planner: Planner, op: str, sizes: Sequence[int], dtype: str
) -> List[dict]:
    """Schema-stamped bench rows of planner decisions across payload
    sizes -- the banked crossover evidence. The size rides IN the
    metric name (the bank gate reduces per metric; see
    comm/bench.py's reshard rows for the original lesson)."""
    from tpu_hpc_torch.obs.schema import stamp

    rows = []
    for size in sizes:
        d = planner.plan(op, size, dtype)
        flat = next(
            c for c in d.candidates if c["mode"] == "flat"
        )
        row = {
            "event": "bench",
            "metric": f"comm_planner_{op}_n{size}_pred_ms",
            "value": round(d.predicted_cost_s * 1e3, 6),
            "unit": "ms",
            "op": op,
            "payload_bytes": size,
            "dtype": dtype,
            "mode": d.mode,
            "source": d.source,
            "fingerprint": d.fingerprint,
            "flat_pred_ms": flat["cost_ms"],
        }
        hier = [
            c for c in d.candidates if c["mode"] == "hierarchical"
        ]
        if hier:
            row["hier_pred_ms"] = hier[0]["cost_ms"]
        rows.append(stamp(row))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="topology-aware collective planner: explain a "
        "decision or sweep the crossover",
    )
    ap.add_argument(
        "--explain", nargs=2, metavar=("OP", "BYTES"), default=None,
        help="print the decision, candidate costs, and which table "
        "(or fallback) supplied them, for one (op, payload)",
    )
    ap.add_argument(
        "--sweep", type=int, nargs="+", metavar="BYTES", default=None,
        help="emit schema-stamped bench rows of the decision at each "
        "payload size (the banked crossover evidence)",
    )
    ap.add_argument(
        "--op", default="all_reduce",
        help="collective for --sweep (default: all_reduce)",
    )
    ap.add_argument("--dtype", default="float32")
    ap.add_argument(
        "--slices", type=int, default=None,
        help="model this many nodes instead of the job's own count "
        "(the JAX CLI's --slices: plan for a topology you do not have "
        "attached)",
    )
    ap.add_argument(
        "--devices", type=int, default=None,
        help="plan for this many cards, one process each, instead of "
        "the live world (1 without a process group)",
    )
    ap.add_argument(
        "--table", default=None, metavar="PATH",
        help="explicit cost-table file (default: the cache dir entry "
        "for the live fingerprint)",
    )
    ap.add_argument(
        "--table-dir", default=None, metavar="DIR",
        help=f"cost-table cache dir (default: ${ENV_TABLE_DIR} or "
        "~/.cache/tpu_hpc/comm_tables)",
    )
    ap.add_argument(
        "--output", default=None, metavar="PATH",
        help="write --sweep rows as JSONL here (default: stdout)",
    )
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if (args.explain is None) == (args.sweep is None):
        ap.error("exactly one of --explain / --sweep is required")
    if args.output and args.sweep is None:
        # The misplaced-flag discipline: an output path the selected
        # action never writes must be an error, not a silent no-file.
        ap.error("--output is only consumed by --sweep")
    if args.table and args.table_dir:
        ap.error("--table and --table-dir are mutually exclusive")

    table = None
    if args.table:
        table = load_table(args.table)  # explicit: corrupt IS fatal
    planner = Planner.for_devices(
        slices=args.slices, table_dir=args.table_dir, table=table,
        n_devices=args.devices,
    )

    if args.explain is not None:
        op, nbytes = args.explain[0], int(args.explain[1])
        decision = (
            planner.plan_grad_sync(
                nbytes, dtype=args.dtype,
                two_tier=planner.fingerprint.two_tier,
            )
            if op == "grad_sync"
            else planner.plan(op, nbytes, args.dtype)
        )
        if args.json:
            print(json.dumps(decision.summary(), indent=1))
            return 0
        print(f"comm planner @ {planner.fingerprint.describe()}")
        t = planner.table
        print(
            f"table: measured {t.path} ({len(t)} entries)" if t
            else "table: absent -> alpha-beta fallback"
        )
        print(decision.explain())
        return 0

    rows = _sweep_rows(planner, args.op, args.sweep, args.dtype)
    text = "\n".join(json.dumps(r) for r in rows)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
        modes = [r["mode"] for r in rows]
        print(
            f"planner sweep: wrote {len(rows)} rows to "
            f"{args.output} (modes: {' '.join(modes)})"
        )
    else:
        print(text)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
