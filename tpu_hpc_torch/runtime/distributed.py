"""Multi-process initialization and launcher auto-detection.

Port of the JAX package's ``runtime/distributed.py``. One
``init_distributed()`` works under every launcher: it reads this
process's ``(rank, world size, coordinator, local rank)`` from the
environment, launcher by launcher, and calls
``torch.distributed.init_process_group`` -- NCCL for a ``cuda`` run,
gloo for a ``cpu`` one. PyTorch runs one process per card, so
``process_id`` is a per-card rank (the JAX package's is a per-host
index).
"""
from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

# torchrun's own default rendezvous port.
_DEFAULT_MASTER_PORT = 29500


@dataclasses.dataclass(frozen=True)
class HostInfo:
    """Identity of this process in the job: its rank, the world size,
    the rendezvous address (``host:port``; None when the launcher gave
    none), the launcher's name, and the rank on its node (which card
    it drives)."""

    process_id: int
    num_processes: int
    coordinator_address: Optional[str]
    launcher: str
    local_rank: int = 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v is not None and v != "":
            try:
                return int(v)
            except ValueError:
                pass
    return None


def _env_str(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _coordinator_from_env() -> Optional[str]:
    """``MASTER_ADDR[:MASTER_PORT]`` when the launcher exported it."""
    addr = _env_str("MASTER_ADDR")
    if addr is None:
        return None
    if ":" in addr:
        return addr
    port = _env_str("MASTER_PORT") or str(_DEFAULT_MASTER_PORT)
    return f"{addr}:{port}"


def get_host_info() -> HostInfo:
    """Detect process identity from the environment, in the JAX
    package's priority order, with torchrun in the place of its
    explicit variables (a TPU pod has no counterpart here):

    1. torchrun (``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
       ``MASTER_PORT``);
    2. SLURM (``SLURM_PROCID``/``SLURM_NTASKS``, more than one task);
    3. OpenMPI (``OMPI_COMM_WORLD_RANK``/``OMPI_COMM_WORLD_SIZE``);
    4. Cray PALS/PMI (``PALS_RANKID``/``PMI_RANK``, ``PALS_SIZE``/
       ``PMI_SIZE``);
    5. a single process.

    Under the schedulers the rendezvous address comes from
    ``MASTER_ADDR`` when it is set, else None (then
    :func:`init_distributed` asks for it).
    """
    pid = _env_int("RANK")
    nproc = _env_int("WORLD_SIZE")
    if pid is not None and nproc is not None:
        return HostInfo(pid, nproc, _coordinator_from_env(), "torchrun",
                        _env_int("LOCAL_RANK") or 0)

    pid = _env_int("SLURM_PROCID")
    nproc = _env_int("SLURM_NTASKS")
    if pid is not None and nproc is not None and nproc > 1:
        return HostInfo(pid, nproc, _coordinator_from_env(), "slurm",
                        _env_int("SLURM_LOCALID") or 0)

    pid = _env_int("OMPI_COMM_WORLD_RANK")
    nproc = _env_int("OMPI_COMM_WORLD_SIZE")
    if pid is not None and nproc is not None:
        return HostInfo(pid, nproc, _coordinator_from_env(), "openmpi",
                        _env_int("OMPI_COMM_WORLD_LOCAL_RANK") or 0)

    pid = _env_int("PALS_RANKID", "PMI_RANK")
    nproc = _env_int("PALS_SIZE", "PMI_SIZE")
    if pid is not None and nproc is not None:
        return HostInfo(pid, nproc, _coordinator_from_env(), "cray_pals",
                        _env_int("PALS_LOCAL_RANKID", "PMI_LOCAL_RANK") or 0)

    return HostInfo(0, 1, None, "single")


def init_distributed(host_info: Optional[HostInfo] = None,
                     device: str = "cuda", verbose: bool = True) -> HostInfo:
    """Join the job's process group: NCCL for ``device="cuda"`` (after
    ``torch.cuda.set_device(local_rank)``), gloo for ``"cpu"``.
    Idempotent, and a no-op for a single process (the reference's
    world_size == 1 fallback)."""
    import torch
    import torch.distributed as dist

    info = host_info or get_host_info()
    if info.is_distributed and not dist.is_initialized():
        if info.coordinator_address is None:
            raise RuntimeError(
                f"{info.launcher} launch of {info.num_processes} processes "
                "without a rendezvous address: export MASTER_ADDR (and "
                "MASTER_PORT)"
            )
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(info.local_rank)
            backend = "nccl"
        else:
            backend = "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://{info.coordinator_address}",
            world_size=info.num_processes, rank=info.process_id,
        )
    if verbose and info.process_id == 0 and info.is_distributed:
        print(f"init_distributed: launcher={info.launcher} process "
              f"{info.process_id}/{info.num_processes} "
              f"host={socket.gethostname()}", flush=True)
    return info


def cleanup_distributed() -> None:
    """Leave the process group (no-op when none is up)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def is_main_host() -> bool:
    """True on rank 0, or when no process group is up."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def print_host0(*args, **kwargs) -> None:
    """Print only from rank 0."""
    if is_main_host():
        print(*args, **kwargs)
