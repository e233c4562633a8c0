"""tpu_hpc_torch.train: the single-device training step and loop
(``trainer``), its meters and MFU (``metrics``), and the bench-Llama
entry point (``python -m tpu_hpc_torch.train``). Importing
``tpu_hpc_torch.train.trainer`` sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False."""
