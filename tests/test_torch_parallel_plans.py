"""The port's plan functions and launcher detection against the JAX
package's, on the same trees and environments. Pure functions: no
process group, no card.

A JAX ``PartitionSpec`` and the port's ``P`` are both tuples of axis
names per dim, so equal plans compare equal entry by entry. The JAX
cases mirrored are tests/test_llama_tp.py (hybrid_pspecs_compose,
validate/auto TP degree), tests/test_train_dp.py (fsdp.param_pspecs),
tests/test_overlap.py (validate_grad_sync_mode) and tests/test_runtime.py
(MeshSpec sizes, get_host_info).
"""
import numpy as np
import pytest

from tpu_hpc_torch.parallel import dp as tdp
from tpu_hpc_torch.parallel import fsdp as tfsdp
from tpu_hpc_torch.parallel import hybrid as thybrid
from tpu_hpc_torch.parallel import plans as tplans
from tpu_hpc_torch.parallel import tp as ttp
from tpu_hpc_torch.runtime import distributed as tdist
from tpu_hpc_torch.runtime import mesh as tmesh


def _jax():
    return pytest.importorskip("jax", reason="the JAX reference package")


@pytest.fixture(scope="module")
def trees():
    """JAX Llama param trees (MHA and GQA) and their numpy copies."""
    jax = _jax()
    from tpu_hpc.models import llama2 as jl

    out = {}
    for name, kv in (("mha", None), ("gqa", 2)):
        cfg = jl.LlamaConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=kv,
                             vocab_size=256, multiple_of=32, max_seq_len=64)
        params = jl.init_llama(jax.random.key(0), cfg)
        out[name] = (params, jax.device_get(params))
    return out


def _flat_jax(specs):
    jax = _jax()
    from jax.sharding import PartitionSpec

    from tpu_hpc.parallel.plans import _path_str

    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {_path_str(path): tuple(spec) for path, spec in leaves}


def _flat(specs):
    out = {}
    tplans.map_with_path(lambda path, s: out.__setitem__(path, tuple(s)),
                         specs)
    return out


def test_spec_is_a_tuple_of_axis_names():
    assert tplans.P("data", None) == ("data", None)
    assert tplans.P() == ()
    assert repr(tplans.P("model")) == "P('model',)"
    assert tdp.batch_pspec() == ("data",) == tfsdp.batch_pspec()


@pytest.mark.parametrize("tree", ["mha", "gqa"])
@pytest.mark.parametrize("rules", ["llama", "llama_axis_tp", "empty"])
def test_pspec_tree_matches_jax(trees, tree, rules):
    from tpu_hpc.parallel import plans as jplans
    from tpu_hpc.parallel import tp as jtp

    jparams, nparams = trees[tree]
    jrules, trules = {
        "llama": (jtp.llama_rules(), ttp.llama_rules()),
        "llama_axis_tp": (jtp.llama_rules("tp"), ttp.llama_rules("tp")),
        "empty": ([], []),
    }[rules]
    want = _flat_jax(jplans.pspec_tree(jparams, jrules))
    got = _flat(tplans.pspec_tree(nparams, trules))
    assert got == want
    assert _flat(ttp.param_pspecs(nparams, trules)) == \
        _flat_jax(jtp.param_pspecs(jparams, jrules))
    lines = tplans.describe_plan(nparams, trules)
    assert [line.split(": ")[0] for line in lines] == \
        [line.split(": ")[0] for line in jplans.describe_plan(jparams, jrules)]
    assert all(": P(" in line for line in lines)


def test_mlp_and_vit_rules_match_jax():
    from tpu_hpc.parallel import plans as jplans
    from tpu_hpc.parallel import tp as jtp

    z = np.zeros((4, 8), np.float32)
    tree = {"main": {"kernel": z}, "fc1": {"kernel": z},
            "fc2": {"kernel": z}, "blk": {"in": {"kernel": z},
                                           "out": {"kernel": z},
                                           "q_proj": {"kernel": z},
                                           "out_proj": {"kernel": z}},
            "up": {"kernel": z}, "down": {"kernel": z}}
    for jr, tr in ((jtp.mlp_rules(), ttp.mlp_rules()),
                   (jtp.vit_rules("m"), ttp.vit_rules("m"))):
        assert _flat(tplans.pspec_tree(tree, tr)) == \
            _flat_jax(jplans.pspec_tree(tree, jr))


@pytest.mark.parametrize("axis_size,min_size", [(2, 1000), (4, 1000),
                                                 (8, 200), (2, 100_000),
                                                 (3, 10)])
def test_fsdp_param_pspecs_match_jax(trees, axis_size, min_size):
    from tpu_hpc.parallel import fsdp as jfsdp

    for jparams, nparams in trees.values():
        want = _flat_jax(jfsdp.param_pspecs(jparams, axis_size=axis_size,
                                            min_size=min_size))
        got = _flat(tfsdp.param_pspecs(nparams, axis_size=axis_size,
                                       min_size=min_size))
        assert got == want
    assert _flat(tdp.param_pspecs(nparams)) == {k: () for k in got}


@pytest.mark.parametrize("data_size,min_size", [(2, 1000), (4, 1000),
                                                 (2, 100_000), (3, 10)])
def test_hybrid_pspecs_match_jax(trees, data_size, min_size):
    from tpu_hpc.parallel import hybrid as jhybrid
    from tpu_hpc.parallel import tp as jtp

    for jparams, nparams in trees.values():
        want = _flat_jax(jhybrid.hybrid_pspecs(
            jparams, jtp.llama_rules(), data_size=data_size,
            min_size=min_size))
        got = _flat(thybrid.hybrid_pspecs(
            nparams, ttp.llama_rules(), data_size=data_size,
            min_size=min_size))
        assert got == want
    if (data_size, min_size) == (2, 1000):
        # tests/test_llama_tp.py::test_hybrid_pspecs_compose's pins.
        assert got["layers_0/attention/wq/kernel"] == ("data", "model")
        assert got["tok_embeddings/embedding"] == ("model", "data")
        assert got["norm/scale"] == ()


def test_derived_pspecs_match_jax_on_an_adamw_state(trees):
    """Adam's mu/nu take their params' specs, the count is replicated;
    the optax state tree (namedtuples) is walked as the JAX one is."""
    jax = _jax()
    import optax

    from tpu_hpc.parallel import hybrid as jhybrid
    from tpu_hpc.parallel import plans as jplans
    from tpu_hpc.parallel import tp as jtp

    jparams, nparams = trees["gqa"]
    jspecs = jhybrid.hybrid_pspecs(jparams, jtp.llama_rules(), data_size=2,
                                   min_size=1000)
    tspecs = thybrid.hybrid_pspecs(nparams, ttp.llama_rules(), data_size=2,
                                   min_size=1000)
    state = jax.device_get(optax.adamw(1e-3).init(jparams))
    want = jax.tree.leaves(
        jplans.derived_pspecs(state, jparams, jspecs),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = tplans.tree_specs(tplans.derived_pspecs(state, nparams, tspecs))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert any(s == ("model", "data") for s in got)


def test_validate_grad_sync_mode_matches_jax(trees):
    from tpu_hpc.parallel import fsdp as jfsdp

    _, nparams = trees["mha"]
    sharded = tfsdp.param_pspecs(nparams, axis_size=8, min_size=100)
    hybrid = thybrid.hybrid_pspecs(nparams, ttp.llama_rules(), data_size=2,
                                   min_size=100)
    for mod in (tfsdp, jfsdp):
        with pytest.raises(ValueError, match="replicated params"):
            mod.validate_grad_sync_mode("bucketed_overlap", sharded)
        with pytest.raises(ValueError, match="replicated params"):
            mod.validate_grad_sync_mode("hierarchical", hybrid)
        with pytest.raises(ValueError, match="unknown comm_mode"):
            mod.validate_grad_sync_mode("turbo", None)
    assert tfsdp.validate_grad_sync_mode("flat", sharded) == "flat"
    assert tfsdp.validate_grad_sync_mode(
        "hierarchical", tdp.param_pspecs(nparams)) == "hierarchical"
    assert tfsdp.GRAD_SYNC_MODES == jfsdp.GRAD_SYNC_MODES


def test_tp_degree_rules_match_jax():
    from tpu_hpc.parallel import tp as jtp

    for args in [(8, 8, 8, None), (8, 8, 8, 4), (6, 8, 8, None),
                 (8, 8, 2, None), (1, 8, 8, None), (5, 8, 8, None),
                 (4, 4, 2, 4), (16, 64, 8, 8)]:
        assert ttp.auto_tp_degree(*args) == jtp.auto_tp_degree(*args)
    for n in range(1, 17):
        for heads, kv in ((8, 8), (4, 2), (64, 8), (6, 6)):
            assert ttp.auto_mesh_axes(n, heads, kv) == \
                jtp.auto_mesh_axes(n, heads, kv)
    for args in [(8, 8, 4), (6, 6, 4), (8, 2, 4), (4, 2, 2)]:
        outcomes = []
        for mod in (ttp, jtp):
            try:
                mod.validate_tp_degree(*args)
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("axes,dcn,n", [
    ({"data": -1}, {}, 8), ({"data": 2, "model": 4}, {}, 8),
    ({"data": -1, "model": 2}, {}, 8), ({"data": 2, "model": 2},
                                        {"data": 2}, 8),
    ({"data": -1, "model": 2}, {"data": 2}, 8),
    ({"data": 1, "model": 4}, {"data": 2}, 8), ({"pipe": 2, "data": -1}, {}, 4),
])
def test_mesh_spec_sizes_match_jax(axes, dcn, n):
    from tpu_hpc.runtime.mesh import MeshSpec as JMeshSpec

    ours, theirs = tmesh.MeshSpec(axes, dcn), JMeshSpec(axes, dcn)
    assert ours.resolved_sizes(n) == theirs.resolved_sizes(n)
    assert ours.ici_sizes(n) == theirs.ici_sizes(n)
    assert ours.axis_names == theirs.axis_names
    assert ours.num_slices == theirs.num_slices


def test_mesh_spec_refusals_match_jax():
    from tpu_hpc.runtime.mesh import MeshSpec as JMeshSpec

    for mod in (tmesh.MeshSpec, JMeshSpec):
        with pytest.raises(ValueError, match="at most one -1"):
            mod(axes={"a": -1, "b": -1}).resolved_sizes(8)
        with pytest.raises(ValueError, match="not present"):
            mod(axes={"data": 2}, dcn_axes={"model": 2})
        with pytest.raises(ValueError, match="not divisible"):
            mod(axes={"data": -1}, dcn_axes={"data": 3}).resolved_sizes(8)
    assert tmesh.local_batch_size(32, {"data": 4}) == 8
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.local_batch_size(30, {"data": 4})
    assert tmesh.mesh_axis_size({"data": 2, "model": 4}, "model") == 4
    assert tmesh.mesh_axis_size({"data": 2}, None) == 1
    # A dcn_axes spec is built two-tier, the across-node part slowest
    # (tests/test_torch_comm.py holds the layout against JAX's).
    assert tmesh.hybrid_rank_grid(tmesh.MeshSpec({"data": 1}, {"data": 2}),
                                  [[0], [1]]).tolist() == [0, 1]


def test_config_mesh_axes_and_spec_match_jax():
    from tpu_hpc.config import TrainingConfig as JCfg

    from tpu_hpc_torch.config import TrainingConfig

    for kw in (dict(), dict(model_parallel=4), dict(
            pipe_parallel=2, seq_parallel=2, data_parallel=2),
            dict(dcn_data_parallel=2, model_parallel=2)):
        ours, theirs = TrainingConfig(**kw), JCfg(**kw)
        assert list(ours.mesh_axes().items()) == \
            list(theirs.mesh_axes().items())
        a, b = ours.mesh_spec(), theirs.mesh_spec()
        assert (dict(a.axes), dict(a.dcn_axes)) == \
            (dict(b.axes), dict(b.dcn_axes))
    for cfg in (TrainingConfig(dcn_data_parallel=0),
                JCfg(dcn_data_parallel=0)):
        with pytest.raises(ValueError, match="dcn_data_parallel"):
            cfg.mesh_spec()


LAUNCH_VARS = ("JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
               "JAX_COORDINATOR_ADDRESS", "TPU_WORKER_ID",
               "TPU_WORKER_HOSTNAMES", "SLURM_PROCID", "SLURM_NTASKS",
               "SLURM_LOCALID", "OMPI_COMM_WORLD_RANK",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
               "PALS_RANKID", "PALS_SIZE", "PALS_LOCAL_RANKID", "PMI_RANK",
               "PMI_SIZE", "PMI_LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "RANK", "WORLD_SIZE", "LOCAL_RANK")
# The JAX package's explicit variables are torchrun's in the port.
TORCHRUN_AS_JAX = {"RANK": "JAX_PROCESS_ID",
                   "WORLD_SIZE": "JAX_NUM_PROCESSES"}


@pytest.mark.parametrize("env,launcher,local_rank", [
    ({}, "single", 0),
    ({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
      "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234"}, "torchrun", 1),
    ({"SLURM_PROCID": "2", "SLURM_NTASKS": "4", "SLURM_LOCALID": "2"},
     "slurm", 2),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}, "single", 0),
    ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4",
      "MASTER_ADDR": "head", "MASTER_PORT": "2222"}, "openmpi", 0),
    ({"PALS_RANKID": "5", "PALS_SIZE": "8"}, "cray_pals", 0),
    ({"PMI_RANK": "1", "PMI_SIZE": "2", "PMI_LOCAL_RANK": "1"},
     "cray_pals", 1),
    ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4",
      "RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h"}, "torchrun", 0),
])
def test_get_host_info_matches_jax(monkeypatch, env, launcher, local_rank):
    """Each launcher's environment gives the same rank and world size
    as the JAX cascade (torchrun standing in for its explicit
    variables), and the torchrun rendezvous address."""
    from tpu_hpc.runtime import distributed as jdist

    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(TORCHRUN_AS_JAX.get(k, k), v)
    theirs = jdist.get_host_info()
    for k in TORCHRUN_AS_JAX.values():
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = tdist.get_host_info()
    assert (ours.process_id, ours.num_processes) == \
        (theirs.process_id, theirs.num_processes)
    assert ours.launcher == launcher
    assert theirs.launcher == ("explicit" if launcher == "torchrun"
                               else launcher)
    assert ours.local_rank == local_rank
    assert ours.is_distributed == theirs.is_distributed
    if "MASTER_ADDR" in env:
        port = env.get("MASTER_PORT", "29500")
        assert ours.coordinator_address == f"{env['MASTER_ADDR']}:{port}"
    if launcher == "single":
        # a single process needs no process group: nothing to join
        assert tdist.init_distributed(ours, device="cpu") == ours
        assert tdist.is_main_host()


def test_topology_report_without_a_card():
    """The job report names its versions and this process's rank; a
    machine without a card lists no devices and no NCCL version."""
    import torch

    from tpu_hpc_torch.runtime import topology

    report = topology.topology_report()
    assert report["torch_version"] == torch.__version__
    assert (report["process_index"], report["process_count"]) == (0, 1)
    if not torch.cuda.is_available():
        assert report["devices"] == [] == topology.device_summary()
        assert report["nccl_version"] is None


def test_mesh_and_rendezvous_refusals():
    """A mesh must cover the job, as the JAX package's whole-job mesh
    must use every chip; a multi-process launch with no rendezvous
    address names MASTER_ADDR. Both raise before any process group."""
    with pytest.raises(ValueError, match="uses 2 of 4 processes"):
        tmesh.build_mesh(tmesh.MeshSpec({"data": 2}), "cpu", world_size=4)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.build_mesh(tmesh.MeshSpec({"data": -1, "model": 3}), "cpu",
                         world_size=4)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tdist.init_distributed(tdist.HostInfo(1, 2, None, "slurm"),
                               device="cpu")
