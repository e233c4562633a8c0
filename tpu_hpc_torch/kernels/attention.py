"""Attention constants shared by the port's kernels.

Only ``MASK_VALUE`` is ported in the serving slice. The flash-attention
forward and its two backward kernels (the JAX package's
``kernels/attention.py``: ``_flash_kernel``, ``_flash_dq_kernel``,
``_flash_dkv_kernel``) come with the training slice; ROADMAP lists
them. The JAX package's ``pick_block_sizes`` is deliberately not
ported: its 128-lane rule is the TPU's, and the Hopper kernels pick
their own tiles (``csrc/paged_attention.cu``).
"""

# Finite mask value (not -inf): a fully masked row keeps a defined
# result -- zero output -- instead of NaN from exp(-inf - -inf).
MASK_VALUE = -1e30
