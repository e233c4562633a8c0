"""tpu_hpc_torch.parallel: the flash-attention factory of the tensor-
parallel layer (``tp.make_tp_flash_attn_fn``), one device only. The
DP/FSDP/TP/hybrid plans over a device mesh are the distributed slice
(ROADMAP queue 1 item 5)."""
