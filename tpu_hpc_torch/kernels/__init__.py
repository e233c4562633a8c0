"""tpu_hpc_torch.kernels: hand-written Hopper kernels and their plain
PyTorch versions (``paged_attention``; ``attention``: the flash
forward, dq and dk/dv), built from ``csrc/`` at first launch
(``_build``)."""
