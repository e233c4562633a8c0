"""Collective micro-benchmark over NVLink and the inter-node fabric: the
``torch_comm_bench`` recipe, on NCCL.

Port of the JAX package's ``comm/bench.py``:

  * broadcast, all-reduce, all-gather, reduce-scatter, ring send/recv
    and all-to-all across element counts 10^3..10^8;
  * N warmup and M timed iterations, each bracketed as the reference's
    ``torch_comm_bench.py`` does: ``barrier; t0; op; synchronize;
    barrier; t1`` (``torch.cuda.synchronize`` on cards);
  * ring bus-bandwidth accounting (:func:`bus_bandwidth_gb_s`, the
    NCCL-tests factors of :func:`wire_factor`);
  * the CSV with an environment-metadata header, and a JSONL with one
    record a line, at the same stem;
  * the two-phase (dcn x inner) all-reduce, all-gather and
    reduce-scatter of ``comm.hierarchical``, each record carrying the
    per-rank wire bytes of its two phases (:func:`two_phase_bytes`), and
    the overlap building blocks of ``comm.overlap`` (the ring
    all-gather and the pipelined gather-matmul, whose time includes its
    partial matmuls -- its busbw row is a lower bound on the gather's
    rate by design);
  * ``--emit-table`` writes the planner's cost table from the run's rows.

Every record has the JAX package's fields (``op``, ``size_elements``,
``bytes_per_shard``, ``dtype``, ``fingerprint``, ``world_size``,
``mean_s`` ... ``busbw_GB_s``). The reshard ops (``RESHARD_OPS``) time
the reshard engine (``tpu_hpc_torch.reshard``): plan and execute of an
axis swap (``reshard_exchange``, and ``reshard_exchange_bounded`` under
``max_inflight_bytes = total / 4``) and of sharded -> replicated
(``reshard_replicate``), in the JAX rows' format (``plan_ms``,
``mean_s``, ``wire_bytes_modeled`` beside ``bytes_moved``, ``chunks``,
``peak_inflight_bytes``).

Run it under torchrun, one process a card:

    torchrun --nproc-per-node 4 -m tpu_hpc_torch.comm.bench \\
        --output build/comm_bench.csv --emit-table build/comm_tables

A one-rank world (no launcher) runs every op over one card: the
collectives are then launch cost, the bus bandwidth of a one-rank
world being 0 by the formula.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
import os
import socket
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_hpc_torch.comm import hierarchical, overlap, primitives

DEFAULT_SIZES = tuple(10**k for k in range(3, 9))
OPS = (
    "broadcast", "all_reduce", "all_gather", "reduce_scatter",
    "ring_shift", "all_to_all",
)
# Two-phase decompositions: need a (dcn x inner) mesh (comm.hierarchical).
HIER_OPS = ("hier_all_reduce", "hier_all_gather", "hier_reduce_scatter")
# Comm/compute-overlap building blocks (comm.overlap), on the flat axis.
OVERLAP_OPS = ("ppermute_all_gather", "gather_matmul")
# Reshard-engine ops (tpu_hpc_torch.reshard): plan + execute timings
# with modeled vs. moved bytes; the exchange also runs a ``_bounded``
# flavor, the chunked decomposition under max_inflight_bytes = total/4.
RESHARD_OPS = ("reshard_exchange", "reshard_replicate")
ALL_OPS = OPS + HIER_OPS + OVERLAP_OPS + RESHARD_OPS

# gather_matmul's fixed output width: the benched payload is the
# sharded weight [K/n, N]; K scales with the requested element count.
_GM_COLS = 128
_GM_ROWS_PER_SHARD = 8

# busbw factor class of each op (NCCL-tests convention, applied to the
# per-shard payload): the hierarchical/overlap ops reuse their flat
# op's factor so their rows compare directly with the flat rows.
_BUSBW_BASE = {
    "broadcast": "broadcast",
    "all_reduce": "all_reduce",
    "all_gather": "all_gather",
    "reduce_scatter": "reduce_scatter",
    "ring_shift": "ring_shift",
    "all_to_all": "all_to_all",
    "hier_all_reduce": "all_reduce",
    "hier_all_gather": "all_gather",
    "hier_reduce_scatter": "reduce_scatter",
    "ppermute_all_gather": "all_gather",
    "gather_matmul": "all_gather",
}


def wire_factor(op: str, n: int) -> float:
    """Per-rank wire share of one flat collective over an ``n``-wide
    axis (the NCCL-tests busbw factor table) -- the one copy: the
    records' busbw and the planner's analytic model both read it."""
    return {
        "broadcast": 1.0,
        "all_reduce": 2.0 * (n - 1) / n,
        "all_gather": (n - 1) / n,
        "reduce_scatter": (n - 1) / n,
        "ring_shift": 1.0,
        "all_to_all": (n - 1) / n,
    }[op]


def bus_bandwidth_gb_s(op: str, bytes_per_shard: int, n: int, t: float) -> float:
    """Ring bus bandwidth: broadcast size/t, all-reduce 2(n-1)/n *
    size/t, all-gather and reduce-scatter (n-1)/n * size/t (the
    NCCL-tests factors). Hierarchical and overlap ops use their flat
    op's factor over the TOTAL axis extent (the phase split is reported
    by :func:`two_phase_bytes`). At n = 1 every factor but broadcast's
    and ring_shift's is 0: a one-rank row is launch cost."""
    if t <= 0:
        return float("inf")
    return wire_factor(_BUSBW_BASE[op], n) * bytes_per_shard / t / 1e9


def two_phase_bytes(
    op: str, bytes_per_shard: int, n_dcn: int, n_ici: int
) -> Tuple[float, float]:
    """Per-rank wire bytes of each phase of a hierarchical op:
    ``(inner_bytes, dcn_bytes)``, S = the per-shard payload:

      hier_all_reduce:     inner 2*S*(n_ici-1)/n_ici   (RS + AG on S)
                           dcn   2*(S/n_ici)*(n_dcn-1)/n_dcn
      hier_all_gather:     inner S*n_dcn*(n_ici-1)     (redistribute)
                           dcn   S*(n_dcn-1)           (one copy each)
      hier_reduce_scatter: inner n*S*(n_ici-1)/n_ici   (scatter on n*S)
                           dcn   S*(n_dcn-1)           (1/n_ici chunk)
    """
    s = float(bytes_per_shard)
    if op == "hier_all_reduce":
        return (
            2.0 * s * (n_ici - 1) / n_ici,
            2.0 * (s / n_ici) * (n_dcn - 1) / n_dcn,
        )
    if op == "hier_all_gather":
        return s * n_dcn * (n_ici - 1), s * (n_dcn - 1)
    if op == "hier_reduce_scatter":
        n = n_dcn * n_ici
        return n * s * (n_ici - 1) / n_ici, s * (n_dcn - 1)
    raise ValueError(f"not a two-phase op: {op}")


def _mesh_size(mesh: Any, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _barrier(device: torch.device) -> None:
    import torch.distributed as dist

    if device.type == "cuda":
        dist.barrier(device_ids=[device.index or 0])
    else:
        dist.barrier()


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class CommBenchmark:
    """Collective benchmark over one axis of a ``DeviceMesh`` (flat and
    overlap ops) or a (dcn x inner) axis pair (hierarchical ops, with
    ``dcn_axis`` naming the outer tier). Every rank of the mesh runs
    :meth:`run` together."""

    mesh: Any
    axis: str = "data"
    sizes: Sequence[int] = DEFAULT_SIZES
    warmup: int = 5   # torch_comm_bench's default
    iters: int = 20
    ops: Sequence[str] = OPS
    dtype: str = "float32"
    dcn_axis: Optional[str] = None

    @property
    def device(self) -> torch.device:
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def _world(self, op: str) -> int:
        n = _mesh_size(self.mesh, self.axis)
        if op in HIER_OPS:
            return n * _mesh_size(self.mesh, self.dcn_axis)
        return n

    def _position(self, op: str) -> int:
        """This rank's shard index over the op's axis (pair)."""
        me = self.mesh.get_local_rank(self.axis)
        if op in HIER_OPS:
            return (self.mesh.get_local_rank(self.dcn_axis)
                    * _mesh_size(self.mesh, self.axis) + me)
        return me

    def _fn_for(self, op: str):
        if op in HIER_OPS:
            if self.dcn_axis is None:
                raise ValueError(
                    f"{op} needs dcn_axis= (a two-tier mesh); got a "
                    "flat single-axis benchmark"
                )
            return getattr(hierarchical, op)(
                self.mesh, self.dcn_axis, self.axis
            )
        if op == "ppermute_all_gather":
            return overlap.ppermute_all_gather(self.mesh, self.axis)
        if op == "gather_matmul":
            return overlap.make_pipelined_gather_matmul(self.mesh, self.axis)
        return getattr(primitives, op)(self.mesh, self.axis)

    def _input_for(self, op: str, n_elements: int):
        """This rank's part of the JAX bench's global payload:
        ``(args, bytes_per_shard)``. ``n_elements`` is the per-shard
        element count (every rank holds ``size`` elements)."""
        n, r = self._world(op), self._position(op)
        dt, dev = getattr(torch, self.dtype), self.device
        if op in ("broadcast", "all_reduce", "all_gather", "ring_shift",
                  "hier_all_reduce", "hier_all_gather",
                  "ppermute_all_gather"):
            # globally arange(n*size), sharded: this rank's `size`.
            x = torch.arange(r * n_elements, (r + 1) * n_elements,
                             dtype=dt, device=dev)
            return (x,), x.numel() * x.element_size()
        if op in ("reduce_scatter", "hier_reduce_scatter"):
            # replicated [n*size] input; output sharded.
            x = torch.arange(n * n_elements, dtype=dt, device=dev)
            return (x,), x.numel() * x.element_size() // n
        if op == "all_to_all":
            # [n, inner] sharded on dim 0 (inner rounded up so the n-way
            # column split is exact): this rank's row.
            inner = -(-n_elements // n) * n
            x = torch.arange(r * inner, (r + 1) * inner, dtype=dt,
                             device=dev).reshape(1, inner)
            return (x,), x.numel() * x.element_size()
        if op == "gather_matmul":
            # FSDP forward shape: x batch-sharded [n*rows, K], the weight
            # dim-0-sharded [K, cols]; the payload is the weight shard.
            k_shard = max(-(-n_elements // _GM_COLS), 1)
            k = n * k_shard
            w = torch.arange(r * k_shard * _GM_COLS,
                             (r + 1) * k_shard * _GM_COLS, dtype=dt,
                             device=dev).reshape(k_shard, _GM_COLS)
            x = torch.ones((_GM_ROWS_PER_SHARD, k), dtype=dt, device=dev)
            return (x, w), w.numel() * w.element_size()
        raise ValueError(op)

    def run(self) -> List[Dict]:
        from tpu_hpc_torch.comm.planner import fingerprint_mesh

        # The planner's cost-table key: a function of the DEVICE SET,
        # so the flat and hierarchical rows of one sweep key one table.
        fp = fingerprint_mesh(self.mesh).digest
        dev = self.device
        records = []
        for op in self.ops:
            fn = self._fn_for(op)
            n = self._world(op)
            for size in self.sizes:
                args, nbytes = self._input_for(op, size)
                for _ in range(self.warmup):
                    fn(*args)
                _synchronize(dev)
                times = []
                for _ in range(self.iters):
                    _barrier(dev)
                    t0 = time.perf_counter()
                    fn(*args)
                    _synchronize(dev)
                    _barrier(dev)
                    times.append(time.perf_counter() - t0)
                times = np.asarray(times)
                rec = {
                    "op": op,
                    "size_elements": size,
                    "bytes_per_shard": nbytes,
                    "dtype": self.dtype,
                    "fingerprint": fp,
                    "world_size": n,
                    "mean_s": float(times.mean()),
                    "std_s": float(times.std()),
                    "min_s": float(times.min()),
                    "max_s": float(times.max()),
                    "busbw_GB_s": bus_bandwidth_gb_s(
                        op, nbytes, n, float(times.mean())
                    ),
                }
                if op in HIER_OPS:
                    n_dcn = _mesh_size(self.mesh, self.dcn_axis)
                    n_ici = _mesh_size(self.mesh, self.axis)
                    ici_b, dcn_b = two_phase_bytes(op, nbytes, n_dcn, n_ici)
                    rec.update({
                        "n_dcn": n_dcn,
                        "n_ici": n_ici,
                        "ici_bytes_per_shard": round(ici_b),
                        "dcn_bytes_per_shard": round(dcn_b),
                        "dcn_fraction": round(
                            dcn_b / (dcn_b + ici_b), 6
                        ) if (dcn_b + ici_b) else 0.0,
                    })
                records.append(rec)
                del args
        return records


def run_reshard_bench(
    mesh: Any,
    axis: str = "data",
    sizes: Sequence[int] = DEFAULT_SIZES,
    warmup: int = 5,
    iters: int = 20,
    ops: Sequence[str] = RESHARD_OPS,
    dtype: str = "float32",
) -> List[Dict]:
    """The reshard engine's plan + execute over ``axis`` of ``mesh`` (a
    ``DeviceMesh`` over the job), as schema-stamped ``bench`` rows with
    the size in the metric name, as the JAX bench writes them:

    * ``reshard_exchange``  -- ``[n, inner]`` sharded dim 0 -> dim 1
      (the Ulysses-style axis swap: one batched P2P exchange);
    * ``reshard_replicate`` -- sharded -> fully replicated (the
      required-residency case; never bounded);
    * ``*_bounded``         -- the exchange under ``max_inflight_bytes
      = total_bytes / 4``: the chunked decomposition's time next to the
      transient it saves (``plan_ms``, ``mean_s``,
      ``wire_bytes_modeled`` vs ``bytes_moved``, ``chunks``,
      ``peak_inflight_bytes``).
    """
    from tpu_hpc_torch import reshard
    from tpu_hpc_torch.comm.planner import fingerprint_mesh
    from tpu_hpc_torch.obs.schema import stamp
    from tpu_hpc_torch.parallel.plans import P

    fp = fingerprint_mesh(mesh).digest
    n = _mesh_size(mesh, axis)
    if n < 2:
        if _rank() == 0:
            print(f"comm.bench: skipping reshard ops -- axis {axis!r} has "
                  f"size {n} (< 2): nothing to redistribute",
                  file=sys.stderr)
        return []
    rmesh = reshard.Mesh.from_device_mesh(mesh)
    dev = CommBenchmark(mesh=mesh).device
    dt = getattr(torch, dtype)
    me = mesh.get_local_rank(axis)
    records: List[Dict] = []
    for op in ops:
        if op not in RESHARD_OPS:
            raise ValueError(f"not a reshard op: {op}")
        flavors = (False, True) if op == "reshard_exchange" else (False,)
        for bounded in flavors:
            for size in sizes:
                if op == "reshard_exchange":
                    inner = -(-size // n) * n
                    shape, src, tgt = (n, inner), P(axis), P(None, axis)
                    x = torch.arange(me * inner, (me + 1) * inner, dtype=dt,
                                     device=dev).reshape(1, inner)
                else:
                    shape, src, tgt = (n * size,), P(axis), P()
                    x = torch.arange(me * size, (me + 1) * size, dtype=dt,
                                     device=dev)
                total = x.numel() * x.element_size() * n
                bound = total // 4 if bounded else None
                t0 = time.perf_counter()
                plan = reshard.plan_reshard(
                    {"x": reshard.TensorSpec(
                        shape, dt, reshard.Sharding(rmesh, src))},
                    {"x": reshard.Sharding(rmesh, tgt)},
                    max_inflight_bytes=bound,
                )
                plan_ms = (time.perf_counter() - t0) * 1e3
                for _ in range(warmup):
                    plan.execute({"x": x}, device=dev)
                _synchronize(dev)
                times = []
                for _ in range(iters):
                    _barrier(dev)
                    t0 = time.perf_counter()
                    plan.execute({"x": x}, device=dev)
                    _synchronize(dev)
                    _barrier(dev)
                    times.append(time.perf_counter() - t0)
                times = np.asarray(times)
                mean = float(times.mean())
                name = op + ("_bounded" if bounded else "")
                step = plan.steps[0]
                common = {
                    "op": name,
                    "size_elements": size,
                    "bytes_per_shard": total // n,
                    "dtype": dtype,
                    "fingerprint": fp,
                    "world_size": n,
                    "max_inflight_bytes": bound,
                }
                # The size rides IN the metric name: the bank gate
                # reduces per metric, and one name for every size would
                # diff min-across-sizes against the last size measured.
                records.append(stamp({
                    "event": "bench",
                    "metric": f"{name}_n{size}_ms",
                    "value": round(mean * 1e3, 6),
                    "unit": "ms",
                    **common,
                    "mean_s": mean,
                    "std_s": float(times.std()),
                    "min_s": float(times.min()),
                    "max_s": float(times.max()),
                    "plan_ms": round(plan_ms, 6),
                    "wire_bytes_modeled": plan.wire_bytes,
                    "bytes_moved": plan.bytes,
                    "peak_inflight_bytes": plan.peak_inflight_bytes,
                    "chunks": step.chunk.count if step.chunk else 1,
                    "busbw_GB_s": (plan.wire_bytes / mean / 1e9
                                   if mean > 0 else float("inf")),
                }))
                records.append(stamp({
                    "event": "bench",
                    "metric": f"{name}_n{size}_wire_bytes",
                    "value": plan.wire_bytes,
                    "unit": "bytes",
                    **common,
                }))
    return records


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _env_metadata(mesh: Any) -> Dict[str, str]:
    """The CSV's metadata header (the reference's: host, versions,
    backend, world size)."""
    import torch.distributed as dist

    cuda = mesh.device_type == "cuda"
    return {
        "hostname": socket.gethostname(),
        "torch_version": torch.__version__,
        "cuda_version": str(torch.version.cuda),
        "backend": str(dist.get_backend()),
        "device_kind": torch.cuda.get_device_name() if cuda else "cpu",
        "process_count": str(dist.get_world_size()),
        "global_devices": str(dist.get_world_size()),
        "mesh": str(dict(zip(mesh.mesh_dim_names, mesh.shape))),
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }


def _fieldnames(records: List[Dict]) -> List[str]:
    """Union of record keys in first-seen order (hierarchical records
    carry phase columns the flat rows lack)."""
    names: List[str] = []
    for r in records:
        for k in r:
            if k not in names:
                names.append(k)
    return names


def write_csv(records: List[Dict], mesh: Any, path: Optional[str]) -> str:
    """Benchmark CSV (metadata as comment lines, then rows); returns
    the text. Rank 0 writes the file."""
    buf = io.StringIO()
    for k, v in _env_metadata(mesh).items():
        buf.write(f"# {k}: {v}\n")
    if records:
        w = csv.DictWriter(buf, fieldnames=_fieldnames(records))
        w.writeheader()
        w.writerows(records)
    text = buf.getvalue()
    if path and _rank() == 0:
        with open(path, "w") as f:
            f.write(text)
    return text


def write_jsonl(records: List[Dict], path: str) -> None:
    """One JSON record a line (rank 0)."""
    if _rank() != 0:
        return
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def run_comm_bench(
    mesh: Any = None,
    axis: str = "data",
    sizes: Sequence[int] = DEFAULT_SIZES,
    warmup: int = 5,
    iters: int = 20,
    ops: Sequence[str] = OPS,
    output: Optional[str] = None,
    dcn: Optional[int] = None,
    hier_mesh: Any = None,
    device_type: Optional[str] = None,
) -> List[Dict]:
    """One-call benchmark (the reference's ``init_processes``; the
    process group must be up). Flat and overlap ops run over ``axis``
    of ``mesh`` (a ``{axis: world}`` mesh when None); hierarchical ops
    over ``hier_mesh`` (``runtime.mesh.two_tier_spec``'s ``{dcn, ici}``
    mesh built on demand: ``dcn=None`` is the node count across nodes,
    an emulated 2 on one; a world it cannot split is skipped with a
    notice, after the flat rows). With ``output=...`` the records land
    as CSV there and JSONL at the same stem; without, the CSV prints."""
    import torch.distributed as dist

    from tpu_hpc_torch.runtime.mesh import (
        MeshSpec,
        build_mesh,
        node_groups,
        two_tier_spec,
    )

    unknown = [op for op in ops if op not in ALL_OPS]
    if unknown:
        raise ValueError(f"unknown ops {unknown}; choose from {ALL_OPS}")
    if device_type is None:
        device_type = (mesh.device_type if mesh is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    flat_ops = [op for op in ops
                if op not in HIER_OPS and op not in RESHARD_OPS]
    hier_ops = [op for op in ops if op in HIER_OPS]
    reshard_ops = [op for op in ops if op in RESHARD_OPS]
    records: List[Dict] = []
    if (flat_ops or reshard_ops) and mesh is None:
        mesh = build_mesh(MeshSpec(axes={axis: -1}), device_type)
    if flat_ops:
        records += CommBenchmark(
            mesh=mesh, axis=axis, sizes=sizes, warmup=warmup,
            iters=iters, ops=flat_ops,
        ).run()
    if reshard_ops:
        records += run_reshard_bench(
            mesh, axis=axis, sizes=sizes, warmup=warmup, iters=iters,
            ops=reshard_ops,
        )
    if hier_ops and hier_mesh is None:
        n_dev = dist.get_world_size() if mesh is None else mesh.size()
        try:
            # Inside the skip handler: an explicit --dcn that disagrees
            # with the node count raises in build_hybrid_mesh, and the
            # flat rows already measured must still be written.
            hier_mesh = build_mesh(
                two_tier_spec(n_dev, len(node_groups()), dcn=dcn),
                device_type)
        except ValueError as e:
            if _rank() == 0:
                print(f"comm.bench: skipping {hier_ops} -- {e}",
                      file=sys.stderr)
            hier_ops = []
    if hier_ops:
        records += CommBenchmark(
            mesh=hier_mesh, axis="ici", dcn_axis="dcn",
            sizes=sizes, warmup=warmup, iters=iters, ops=hier_ops,
        ).run()
    meta_mesh = mesh if mesh is not None else hier_mesh
    if meta_mesh is None:
        return records
    if output:
        # <stem>.csv and <stem>.jsonl, whichever of the two was named.
        stem, ext = os.path.splitext(output)
        csv_path = stem + ".csv" if ext == ".jsonl" else output
        jsonl_path = stem + ".jsonl"
        write_csv(records, meta_mesh, csv_path)
        write_jsonl(records, jsonl_path)
        if _rank() == 0:
            print(f"comm bench: wrote {csv_path} and {jsonl_path}")
    else:
        text = write_csv(records, meta_mesh, None)
        if _rank() == 0:
            print(text)
    return records


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="NCCL collective benchmark over NVLink and the "
        "inter-node fabric (tpu_hpc_torch.comm.bench)"
    )
    p.add_argument("--sizes", type=int, nargs="+", default=list(DEFAULT_SIZES))
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--ops", nargs="+", default=list(OPS + HIER_OPS
                                                    + OVERLAP_OPS),
                   choices=ALL_OPS)
    p.add_argument(
        "--op", action="append", default=None, choices=ALL_OPS,
        metavar="OP",
        help="bench only this op (repeatable); overrides --ops",
    )
    p.add_argument(
        "--output", type=str, default="comm_bench.csv",
        help="CSV path; a JSONL lands at the same stem ('-' = print "
        "CSV to stdout only)",
    )
    p.add_argument(
        "--emit-table", type=str, default=None, metavar="PATH",
        help="also write the planner's cost table built from this run's "
        "rows (tpu_hpc_torch.comm.planner CostTable JSON). A directory "
        "writes <fingerprint>.json inside it -- point it at the "
        "planner's cache dir ($TPU_HPC_COMM_TABLES) and "
        "comm_mode='auto' picks the measurements up",
    )
    p.add_argument(
        "--dcn", type=int, default=None,
        help="outer-tier extent for the hierarchical ops' (dcn x ici) "
        "mesh; default: the node count across nodes, else an emulated "
        "2",
    )
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (NCCL, default) or cpu (gloo)")
    args = p.parse_args(argv)
    ops = tuple(args.op) if args.op else tuple(args.ops)

    from tpu_hpc_torch.runtime import (
        cleanup_distributed,
        init_distributed,
        resolve_device,
    )
    from tpu_hpc_torch.runtime.sim import free_port

    import torch.distributed as dist

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    info = init_distributed(device=device.type, verbose=False)
    if not dist.is_initialized():
        # No launcher: a one-rank world over this card.
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{free_port()}", world_size=1,
            rank=0)
    elif device.type == "cuda":
        torch.cuda.set_device(info.local_rank)
    try:
        output = None if args.output == "-" else args.output
        records = run_comm_bench(
            sizes=args.sizes, warmup=args.warmup, iters=args.iters, ops=ops,
            output=output, dcn=args.dcn, device_type=device.type,
        )
        if args.emit_table and _rank() == 0:
            from tpu_hpc_torch.comm import planner

            try:
                # The whole job's fingerprint: the rows key the live
                # topology's table.
                table = planner.CostTable.from_rows(
                    records,
                    fingerprint=planner.fingerprint_devices(
                        device_type=device.type))
            except planner.CostTableError as e:
                print(f"comm bench: --emit-table skipped -- {e}",
                      file=sys.stderr)
            else:
                path = table.save(args.emit_table)
                print(f"comm bench: wrote cost table {path} "
                      f"({len(table)} entries, fingerprint {table.digest})")
    finally:
        cleanup_distributed()


if __name__ == "__main__":
    main()
