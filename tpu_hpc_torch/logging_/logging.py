"""Host-aware logging. Parity: utils/logging.py (get_logger :26-39,
rank_log :42-52, verify_min_gpu_count :55-65)."""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
_configured = False


def get_logger(
    name: str = "tpu_hpc", level: Optional[int] = None
) -> logging.Logger:
    """Process-safe logger; basicConfig applied once (parity with the
    import-time basicConfig at utils/logging.py:19-23, but lazy).

    ``level`` is honored on EVERY call, not just the configuring one:
    an explicit level sets that logger's own level, while the default
    (None) leaves the logger inheriting -- so ``get_logger()`` after a
    ``get_logger(name, DEBUG)`` cannot silently clobber the earlier
    request."""
    global _configured
    if not _configured:
        logging.basicConfig(
            level=logging.INFO if level is None else level,
            format=_FORMAT, stream=sys.stdout,
        )
        _configured = True
    logger = logging.getLogger(name)
    if level is not None:
        logger.setLevel(level)
    return logger


def process_rank() -> int:
    """This process's rank: the process group's when one is up, else
    ``$RANK`` (torchrun's export), else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    try:
        return int(os.environ.get("RANK", "0") or 0)
    except ValueError:
        return 0


def host_log(msg: str, *args, logger: logging.Logger | None = None) -> None:
    """Log only from rank 0. Parity: rank_log (utils/logging.py:42-52)."""
    if process_rank() == 0:
        (logger or get_logger()).info(msg, *args)


def verify_min_device_count(min_devices: int) -> bool:
    """Guard for recipes needing N cards. Parity: verify_min_gpu_count
    (utils/logging.py:55-65)."""
    import torch

    return torch.cuda.device_count() >= min_devices
