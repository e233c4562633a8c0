"""tpu_hpc_torch.ckpt: checkpoints over torch.distributed.checkpoint
(``checkpoint.py``) and their content checksums (``integrity.py``)."""
from tpu_hpc_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    TopologyMismatchError,
)
from tpu_hpc_torch.ckpt.integrity import (  # noqa: F401
    CkptIntegrityError,
    leaf_checksums,
    verify_tree,
)
