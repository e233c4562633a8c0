"""tpu_hpc_torch.config: the training configuration (``TrainingConfig``),
the same fields as the JAX package's."""
from tpu_hpc_torch.config.config import TrainingConfig  # noqa: F401

__all__ = ["TrainingConfig"]
