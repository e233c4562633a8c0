"""Per-process output capture, including native (CUDA, NCCL) output.

Parity: utils/redirect.py:5-38, which dup2's FDs 1/2 so NCCL/MPI C-level
prints land in per-rank files.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Iterator


@contextlib.contextmanager
def redirect_output(prefix: str, process_id: int | None = None) -> Iterator[None]:
    """Redirect this process's stdout/stderr (Python AND native) to
    ``{prefix}.{pid}.out`` / ``{prefix}.{pid}.err``; ``process_id``
    defaults to this process's rank (``logging.process_rank``)."""
    if process_id is None:
        try:
            from tpu_hpc_torch.logging_.logging import process_rank

            process_id = process_rank()
        except Exception:
            process_id = 0
    out_path = f"{prefix}.{process_id}.out"
    err_path = f"{prefix}.{process_id}.err"
    sys.stdout.flush()
    sys.stderr.flush()
    saved_out = os.dup(1)
    saved_err = os.dup(2)
    with open(out_path, "w") as fo, open(err_path, "w") as fe:
        os.dup2(fo.fileno(), 1)  # native-level capture (utils/redirect.py:26-27)
        os.dup2(fe.fileno(), 2)
        old_stdout, old_stderr = sys.stdout, sys.stderr
        sys.stdout = os.fdopen(os.dup(1), "w", buffering=1)
        sys.stderr = os.fdopen(os.dup(2), "w", buffering=1)
        try:
            yield
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            sys.stdout, sys.stderr = old_stdout, old_stderr
            os.dup2(saved_out, 1)
            os.dup2(saved_err, 2)
            os.close(saved_out)
            os.close(saved_err)
