"""tpu_hpc_torch.serve: batched inference on one card.

Port of the JAX package's ``tpu_hpc.serve``: a preallocated KV cache
driven by built prefill/decode programs (engine), the paged KV pool
with prefix reuse and chunked prefill (paging), continuous batching
over fixed slots (scheduler), weights into the serving layout
(weights), TTFT/ITL/throughput accounting (metrics), and a local
request-replay CLI (``python -m tpu_hpc_torch.serve``, server).
Disaggregated serving, speculative decoding, the host KV tier and the
fleet are later slices (ROADMAP).
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
    "UnservableRequestError",
    "params_from_numpy",
    "place_params",
    "replay_requests",
]
