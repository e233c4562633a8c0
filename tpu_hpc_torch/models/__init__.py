"""tpu_hpc_torch.models: Llama-2 (``llama2``). The other model
families of the JAX package come with later slices (ROADMAP)."""
