"""Host-aware logging and per-process output capture, ported from the
JAX package's ``logging_/`` (``get_logger`` and ``redirect_output`` are
framework-free copies; ``host_log`` and ``verify_min_device_count``
read the torch process group and the CUDA device count)."""
from tpu_hpc_torch.logging_.logging import (  # noqa: F401
    get_logger,
    host_log,
    verify_min_device_count,
)
from tpu_hpc_torch.logging_.redirect import redirect_output  # noqa: F401
