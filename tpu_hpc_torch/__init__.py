"""tpu_hpc_torch: the PyTorch/CUDA port of ``tpu_hpc``, for one NVIDIA
H100.

The JAX package beside it stays the reference. The port keeps its
module layout and public names so each module's counterpart is easy to
find; every Pallas kernel on a ported path becomes a hand-written
Hopper kernel (``csrc/``), with a plain PyTorch version beside it.

The slices so far: serving Llama-2 through the paged KV cache
(``python -m tpu_hpc_torch.serve --paged --kv-kernel cuda``); training
the bench Llama through the flash-attention kernels (``python -m
tpu_hpc_torch.train``), on one card, over a (data, model) mesh under
``torchrun``, or sequence-parallel over a (data, context) mesh
(``--sp-mode ring|zigzag|ulysses``); and training that survives -- checkpoints (``ckpt``), the
numeric-health guard, preemption and the restart supervisor
(``resilience``); observability -- the trace analyzer and anomaly
capture (``obs``), ``torch.profiler`` windows (``profiling``) and
host-aware logging (``logging_``); the native data path (``native``:
the C++ token and record readers, ``python -m tpu_hpc_torch.train
--tokens-file``) and the operator tools (``checks``: fit, doctor,
roofline, env_check, collectives; ``runtime.tuning``;
``kernels.autotune``). With them the port holds every module of the
JAX package. Nothing here imports jax or ``tpu_hpc``.
Importing this package does not import its subpackages.
"""
