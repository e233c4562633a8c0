"""tpu_hpc_torch.models: Llama-2 (``llama2``), its losses (``losses``)
and the synthetic token stream (``datasets``). The other model families
of the JAX package come with later slices (ROADMAP)."""
