from tpu_hpc_torch.profiling.profiler import (  # noqa: F401
    TrainingProfiler,
    device_memory_summary,
    profiler_busy,
    training_profiler,
)
