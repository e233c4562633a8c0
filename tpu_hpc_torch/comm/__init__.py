"""tpu_hpc_torch.comm: the communication layer over NCCL (gloo on the
CPU) -- the JAX package's ``tpu_hpc.comm``, with its exports.

``primitives`` (the six named collectives over one mesh axis),
``hierarchical`` (two-phase collectives over a (dcn x inner) mesh),
``overlap`` (bucketed gradient sync driven by the backward, the ring
all-gather and the pipelined gather-matmul), ``bench`` (the collective
benchmark) and ``planner`` (the topology fingerprint, cost tables in
the JAX on-disk format, and the gradient-sync decision). The exports
load with their module on first use, so ``python -m
tpu_hpc_torch.comm.bench`` (or ``.planner``) runs its module once.
"""
import importlib

_EXPORTS = {
    "primitives": ("all_gather", "all_reduce", "all_to_all", "broadcast",
                   "reduce_scatter", "ring_shift"),
    "hierarchical": ("all_gather_two_phase", "hier_all_gather",
                     "hier_all_reduce", "hier_reduce_scatter",
                     "psum_two_phase", "reduce_scatter_two_phase"),
    "overlap": ("gather_matmul", "make_pipelined_gather_matmul",
                "make_synced_value_and_grad", "ppermute_all_gather",
                "ring_all_gather"),
    "bench": ("CommBenchmark", "run_comm_bench"),
    "planner": ("CommDecision", "CostTable", "Planner",
                "TopologyFingerprint", "fingerprint_devices",
                "fingerprint_mesh", "plan_trainer_grad_sync"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_MODULE_OF[name]}")
    return getattr(module, name)
