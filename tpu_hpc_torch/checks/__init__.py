"""tpu_hpc_torch.checks: the per-card peak table (``roofline``) and the
rule the flash kernels are held to against their plain versions
(``tolerance``). The JAX package's fit analyzer, step-time estimator and
environment checks come with later slices (ROADMAP)."""
