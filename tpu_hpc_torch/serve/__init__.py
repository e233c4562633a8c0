"""tpu_hpc_torch.serve: batched inference on one card.

Port of the JAX package's ``tpu_hpc.serve``: a preallocated KV cache
driven by built prefill/decode programs (engine), the paged KV pool
with prefix reuse and chunked prefill (paging), continuous batching
over fixed slots (scheduler), speculative decoding and seeded
temperature/top-p sampling on the paged engine (spec, with the threefry
key chain in prng), weights into the serving layout (weights),
TTFT/ITL/throughput accounting (metrics), and a local request-replay
and load-scenario CLI (``python -m tpu_hpc_torch.serve``, server).
Disaggregated serving, the host KV tier and the fleet are later slices
(ROADMAP).
"""
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
from tpu_hpc_torch.serve.weights import params_from_numpy, place_params

__all__ = [
    "AdmissionPolicy",
    "BlockAllocator",
    "BlockBudgetError",
    "ContinuousBatcher",
    "Engine",
    "PagedConfig",
    "PagedEngine",
    "PrefixTrie",
    "Request",
    "ServeConfig",
    "ServeMeter",
    "SpecConfig",
    "SpecRunner",
    "UnservableRequestError",
    "attach_spec",
    "derive_request_seed",
    "params_from_numpy",
    "place_params",
    "replay_requests",
]
