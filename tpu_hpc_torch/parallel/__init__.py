"""tpu_hpc_torch.parallel: sharding plans and their layout on a mesh.

``plans`` (spec trees from path rules), ``dp``, ``fsdp``, ``tp`` (the
Megatron rules, SP, flash attention on local heads) and ``hybrid``
(FSDP x TP) are the JAX package's plan functions; ``shard`` carries a
plan out on a (data, model) ``DeviceMesh`` with DTensor TP and FSDP2.
Sequence parallelism over a (data, context) mesh: ``ring_attention``
(the contiguous and zigzag rings), ``sp_ulysses`` (the all-to-all head
scatter) and ``sp_transport`` (how their tensors move between context
ranks: a process group, or every rank in one process). Domain
parallelism over latitude bands: ``domain`` (halo exchange, halo convs,
pooling and upsampling on bands, their transports) and ``domain_unet``
(the whole U-Net over bands).
"""
