"""A multi-process world on one host: the no-cluster development mode.

The JAX package simulates N devices inside one process
(``runtime/sim.py``). PyTorch runs one process per device, so the
port's counterpart starts N local processes with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): ``init_distributed(device="cpu")`` then joins them
as one gloo world, and every mesh recipe runs on a laptop CPU.
"""
from __future__ import annotations

import os
import socket
import subprocess
from typing import List, Mapping, Optional, Sequence, Tuple


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local_world(argv: Sequence[str], world_size: int, *,
                       env: Optional[Mapping[str, str]] = None,
                       cwd: Optional[str] = None) -> List[subprocess.Popen]:
    """Start ``world_size`` copies of ``argv``, ranks 0 .. n-1 of one
    job rendezvousing on a free localhost port; each gets one thread
    (``OMP_NUM_THREADS=1``). Collect them with :func:`wait_world`."""
    port = str(free_port())
    procs = []
    for rank in range(world_size):
        penv = dict(os.environ if env is None else env, RANK=str(rank),
                    WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                    MASTER_ADDR="localhost", MASTER_PORT=port,
                    OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            list(argv), env=penv, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def wait_world(procs: Sequence[subprocess.Popen],
               timeout: float = 240.0) -> List[Tuple[int, str, str]]:
    """Wait for every process of a world; any still running on the way
    out (a timeout, an error) is killed. Returns ``(returncode,
    stdout, stderr tail)`` per rank."""
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            logs.append((p.returncode, out, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return logs
