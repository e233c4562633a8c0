"""tpu_hpc_torch.native: the C++ data path (port of the JAX package's
``native/``): the mmap'd record and token readers with their threaded
prefetch ring (``dataloader``), text -> token-corpus preparation
(``prepare``) and the real-image records (``vision``)."""
from tpu_hpc_torch.native.dataloader import (  # noqa: F401
    NativeERA5Stream,
    NativeFileDataset,
    NativeTokenDataset,
    load_library,
    prepare_on_host0,
    write_dataset,
    write_token_dataset,
)

_PREPARE_EXPORTS = ("TokenDatasetWriter", "prepare_corpus")
_VISION_EXPORTS = ("NativeImageClassDataset", "prepare_digits")


def __getattr__(name):
    # Lazy: importing prepare/vision here would make
    # `python -m tpu_hpc_torch.native.prepare` (or .vision) re-execute
    # the module (runpy's found-in-sys.modules warning).
    if name in _PREPARE_EXPORTS:
        from tpu_hpc_torch.native import prepare

        return getattr(prepare, name)
    if name in _VISION_EXPORTS:
        from tpu_hpc_torch.native import vision

        return getattr(vision, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
