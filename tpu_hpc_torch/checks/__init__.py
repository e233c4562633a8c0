"""tpu_hpc_torch.checks: the operator tools. The per-card table and
the step-time estimator (``roofline``), the shard/fit analyzer
(``fit``), the strategy doctor over both (``doctor``), the pre-flight
environment checks (``env_check``), the collective counter over
profiler traces (``collectives``, the counterpart of the JAX
``checks/hlo.py``) and the rule the kernels are held to against their
plain versions (``tolerance``). Each is imported on its own
(``python -m tpu_hpc_torch.checks.fit`` and the like)."""
