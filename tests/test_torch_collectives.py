"""The port's collective counter (tpu_hpc_torch.checks.collectives, the
counterpart of the JAX package's checks/hlo.py) over torch.profiler
traces of real updates on a gloo world of 2, and its spelling map.

The world's property is the one tests/test_torch_comm_sync.py pins from
the sync's own counter: a bucketed-sync update issues n_buckets + 1
all-reduces (the buckets and the loss). Here the profiler sees them.
"""
import json
import os
import sys

import pytest
import torch

from tpu_hpc_torch.checks import collectives as col

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 16
SMALL_BUCKET = 16 * 1024


def _world_main(workdir):
    """One rank (run as a script): a bucketed-sync update and an FSDP
    update of a small Llama, each under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_hpc_torch.comm import planner
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
    )
    from tpu_hpc_torch.train import __main__ as tmain

    torch.set_num_threads(1)
    info = init_distributed(device="cpu", verbose=False)
    r = info.process_id
    mesh = build_mesh(MeshSpec(axes={"data": 2}), "cpu")
    cfg = tmain.bench_model_cfg(SEQ, dim=64, n_layers=2, n_heads=4,
                                vocab_size=128, multiple_of=16)
    decision = planner.CommDecision(
        op="grad_sync", payload_bytes=1, dtype="float32",
        mode="bucketed_overlap", bucket_bytes=SMALL_BUCKET,
        predicted_cost_s=1e-3, source="measured", fingerprint="test",
        table=None, candidates=())
    run = dict(steps=1, epochs=1, batch=2, grad_accum_steps=2,
               device="cpu", attn="reference", mesh=mesh)
    out = {}
    for case, kw in (("bucketed", dict(comm_mode="auto", comm_plan=decision)),
                     ("fsdp", dict(plan="fsdp"))):
        trainer, ds = tmain.build_trainer(cfg, **run, **kw)
        batch = ds.batch_at(0, trainer.cfg.global_batch_size)
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            trainer.train_step(batch)
        trace = os.path.join(workdir, f"{case}.rank{r}.json")
        prof.export_chrome_trace(trace)
        sync = trainer.grad_sync
        out[case] = {
            "counts": col.collective_counts(prof),
            "counts_from_file": col.collective_counts(trace),
            "shapes": col.collective_group_shapes(trace, "all-reduce"),
            "n_buckets": sync.n_buckets if sync is not None else None,
            "max_bytes": col.max_tensor_bytes(trace),
        }
        if sync is not None:
            sync.remove()
    with open(os.path.join(workdir, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    cleanup_distributed()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    workdir = tmp_path_factory.mktemp("collectives_world")
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), str(workdir)], 2,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    return [json.load(open(workdir / f"rank{r}.json")) for r in range(2)]


@pytest.mark.parametrize("rank", [0, 1])
def test_bucketed_update_issues_n_buckets_plus_one_allreduces(ranks, rank):
    b = ranks[rank]["bucketed"]
    assert b["n_buckets"] > 1  # the small bucket splits the gradient
    assert b["counts"]["all-reduce"] == b["n_buckets"] + 1
    assert b["counts"]["all-gather"] == b["counts"]["reduce-scatter"] == 0
    assert b["counts_from_file"] == b["counts"]
    assert b["shapes"] == [[1, 2]] * (b["n_buckets"] + 1)  # JSON lists


@pytest.mark.parametrize("rank", [0, 1])
def test_fsdp_update_gathers_and_scatters(ranks, rank):
    f = ranks[rank]["fsdp"]
    assert f["counts"]["all-gather"] > 0
    assert f["counts"]["reduce-scatter"] > 0
    assert f["counts"]["collective-permute"] == 0
    assert f["counts_from_file"] == f["counts"]
    assert f["max_bytes"] > 0


@pytest.mark.parametrize("name,want", [
    ("c10d::allreduce_", (1, "all-reduce")),
    ("_c10d_functional::all_reduce", (1, "all-reduce")),
    ("c10d::_allgather_base_", (1, "all-gather")),
    ("_c10d_functional::all_gather_into_tensor", (1, "all-gather")),
    ("c10d::_reduce_scatter_base_", (1, "reduce-scatter")),
    ("_c10d_functional::reduce_scatter_tensor", (1, "reduce-scatter")),
    ("c10d::alltoall_base_", (1, "all-to-all")),
    ("c10d::send", (1, "collective-permute")),
    ("c10d::recv_", (1, "collective-permute")),
    ("nccl:all_reduce", (2, "all-reduce")),
    ("gloo:all_gather", (2, "all-gather")),
    ("nccl:_reduce_scatter_base", (2, "reduce-scatter")),
    ("nccl:send", (2, "collective-permute")),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", (3, "all-reduce")),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t", (3, "all-gather")),
    ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL", (3, "reduce-scatter")),
    ("ncclDevKernel_SendRecv", (3, "collective-permute")),
    ("c10d::barrier", None),
    ("aten::mm", None),
    ("nccl:barrier", None),
])
def test_spelling_map(name, want):
    assert col.spelling_kind(name) == want


def test_counts_read_one_level_only():
    """An all-reduce seen as its op, its backend record and its kernel
    counts once; a trace with only kernels is read at that level."""
    events = ["c10d::allreduce_", "nccl:all_reduce",
              "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
              "c10d::_allgather_base_", "nccl:_all_gather_base"]
    counts = col.collective_counts(events)
    assert counts == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 0,
                      "collective-permute": 0, "all-to-all": 0}
    assert list(counts) == list(col.COLLECTIVE_OPS)
    kernels = ["ncclDevKernel_AllReduce_Sum_f32_RING_LL"] * 3
    assert col.collective_counts(kernels)["all-reduce"] == 3
    assert col.collective_counts([])["all-reduce"] == 0


def test_same_kinds_as_jax():
    hlo = pytest.importorskip("tpu_hpc.checks.hlo")
    assert col.COLLECTIVE_OPS == hlo.COLLECTIVE_OPS


def test_group_size_from_the_event_args():
    events = [{"name": "nccl:all_reduce", "args": {"Group size": 4}},
              {"name": "nccl:all_reduce"}]
    assert col.collective_group_shapes(events, "all-reduce") == [(1, 4),
                                                                (1, 1)]
    with pytest.raises(ValueError, match="unknown collective"):
        col.collective_group_shapes(events, "psum")


def test_max_tensor_bytes_needs_memory_events():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        x = torch.empty((1024, 1024), dtype=torch.float32)
        x.add_(1.0)
    assert col.max_tensor_bytes(prof) >= 4 * 1024 * 1024
    with pytest.raises(ValueError, match="profile_memory=True"):
        col.max_tensor_bytes(["aten::mm"])


if __name__ == "__main__":
    _world_main(sys.argv[1])
