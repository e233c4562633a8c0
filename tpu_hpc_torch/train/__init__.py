"""tpu_hpc_torch.train: only ``metrics.mfu`` so far (the serving meter
divides by it). The training step, loop and optimizer are the next
slice (ROADMAP)."""
