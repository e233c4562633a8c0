"""tpu_hpc_torch.serve: batched inference on one card.

Port of the JAX package's ``tpu_hpc.serve``: a preallocated KV cache
driven by built prefill/decode programs (engine), the paged KV pool
with prefix reuse and chunked prefill (paging), continuous batching
over fixed slots (scheduler), speculative decoding and seeded
temperature/top-p sampling on the paged engine (spec, with the threefry
key chain in prng), weights into the serving layout (weights),
TTFT/ITL/throughput accounting (metrics), the host-DRAM KV page tier
behind the paged pool (tier), the multi-replica fleet -- router,
redispatch, autoscale, weight hot-swap -- and its load harness (fleet),
disaggregated prefill/decode tiers whose KV hop is a reshard plan
(disagg), and a local request-replay, load-scenario and fleet CLI
(``python -m tpu_hpc_torch.serve``, server).
"""
from tpu_hpc_torch.serve.disagg import DisaggEngine, split_serving_meshes
from tpu_hpc_torch.serve.engine import Engine, ServeConfig
from tpu_hpc_torch.serve.metrics import ServeMeter
from tpu_hpc_torch.serve.paging import (
    BlockAllocator,
    BlockBudgetError,
    PagedConfig,
    PagedEngine,
    PrefixTrie,
    UnservableRequestError,
)
from tpu_hpc_torch.serve.scheduler import (
    AdmissionPolicy,
    ContinuousBatcher,
    Request,
    replay_requests,
)
from tpu_hpc_torch.serve.spec import (
    SpecConfig,
    SpecRunner,
    attach_spec,
    derive_request_seed,
)
from tpu_hpc_torch.serve.weights import (
    load_serving_params,
    params_from_numpy,
    place_params,
    serving_pspecs,
)

# fleet.py exports are lazy (PEP 562): fleet imports loadgen.harness,
# which imports this package -- an eager re-export would close the
# loop through the partially-initialized loadgen package.
_FLEET_EXPORTS = (
    "FleetConfig",
    "FleetHarness",
    "ServingFleet",
    "build_fleet_engines",
    "split_fleet_devices",
)


def __getattr__(name):
    if name in _FLEET_EXPORTS:
        from tpu_hpc_torch.serve import fleet

        return getattr(fleet, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


__all__ = [
    "AdmissionPolicy",
    "BlockAllocator",
    "BlockBudgetError",
    "ContinuousBatcher",
    "DisaggEngine",
    "Engine",
    "FleetConfig",
    "FleetHarness",
    "PagedConfig",
    "PagedEngine",
    "PrefixTrie",
    "Request",
    "ServeConfig",
    "ServeMeter",
    "ServingFleet",
    "SpecConfig",
    "SpecRunner",
    "UnservableRequestError",
    "attach_spec",
    "build_fleet_engines",
    "derive_request_seed",
    "load_serving_params",
    "params_from_numpy",
    "place_params",
    "replay_requests",
    "serving_pspecs",
    "split_fleet_devices",
    "split_serving_meshes",
]
