"""tpu_hpc_torch.kernels: hand-written Hopper kernels and their plain
PyTorch versions (``paged_attention``), built from ``csrc/`` at first
launch (``_build``)."""
