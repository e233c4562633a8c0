"""Curated NCCL / CUDA / PyTorch performance-knob presets.

Port of the JAX package's ``runtime/tuning.py``: the same profiles by
name (``default``, ``collective-overlap``, ``data-parallel``,
``memory-bound``) and the same merge rules, over the knobs a PyTorch job
on H100 cards has -- the NCCL / CUDA / allocator environment the
reference's launchers export (its NCCL tuning block) instead of the
TPU compiler's flags. Kept in code so they are versioned, named and
testable instead of pasted.

They are read once, when CUDA and NCCL initialize, so ``apply_tuning``
must run before the first CUDA call and before
``init_process_group`` (the reference's must-export-before-init
contract).

Usage (launcher or program entry)::

    from tpu_hpc_torch.runtime import tuning
    tuning.apply_tuning("collective-overlap")   # before any CUDA use
    init_distributed()

or in a shell launcher: ``eval $(python -m tpu_hpc_torch.runtime.tuning
--profile collective-overlap --shell)``.

Each variable is a list of tokens: ``PYTORCH_CUDA_ALLOC_CONF`` is the
allocator's comma-separated ``key:value`` list (a token is named by its
key); every other variable holds one value (the variable names its one
token).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

# Overlap collectives with compute.
_OVERLAP = {
    # One hardware work queue per device: kernels start in issue order,
    # so a collective issued before a matmul is scheduled before it and
    # runs under it (Megatron's setting for TP/SP overlap) instead of
    # queueing behind it.
    "CUDA_DEVICE_MAX_CONNECTIONS": "1",
    # ProcessGroupNCCL keeps a collective's inputs alive by stashing
    # them until the collective's event completes rather than calling
    # record_stream, so FSDP's gathered buffers return to the caching
    # allocator on time and the next gather can reuse them.
    "TORCH_NCCL_AVOID_RECORD_STREAMS": "1",
}

# Each profile: env var -> value. A preset token the user already set
# is dropped (see tuning_env), so the user's value wins.
PROFILES: Dict[str, Dict[str, str]] = {
    # No-op: measure first, tune second.
    "default": {},
    "collective-overlap": dict(_OVERLAP),
    # Pure-DP jobs: the overlap set plus NVLink SHARP, which reduces
    # inside the NVSwitch and halves the bytes an all-reduce moves on an
    # H100 SXM node -- the collective a DP job spends its comm time in.
    "data-parallel": {**_OVERLAP, "NCCL_NVLS_ENABLE": "1"},
    # Jobs at the edge of HBM: expandable segments let the caching
    # allocator grow one mapping instead of stranding memory in
    # fixed-size blocks (fragmentation is what turns a sliver-OOM into
    # an OOM), and prompt buffer release keeps FSDP's gathered params
    # from piling up.
    "memory-bound": {
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
        "TORCH_NCCL_AVOID_RECORD_STREAMS": "1",
    },
}

# Profiles whose tokens OVERRIDE a pre-existing value instead of
# yielding to it: memory-bound exists to flip a setting an earlier
# export may hold the other way (expandable_segments:False), so under
# the usual user-wins merge it would silently no-op in exactly its
# headline scenario.
_FORCE_PROFILES = frozenset({"memory-bound"})

# Variables that hold a list of tokens, and the token separator.
_LIST_VARS = {"PYTORCH_CUDA_ALLOC_CONF": ","}


def _tokens(var: str, value: str) -> List[str]:
    sep = _LIST_VARS.get(var)
    if sep is None:
        return [value.strip()] if value.strip() else []
    return [t.strip() for t in value.split(sep) if t.strip()]


def _token_name(var: str, token: str) -> str:
    """``expandable_segments:True`` -> ``expandable_segments``; a
    one-value variable's token is named by the variable."""
    if var not in _LIST_VARS:
        return var
    return token.split(":", 1)[0]


def _join(var: str, tokens: List[str]) -> str:
    return _LIST_VARS.get(var, " ").join(tokens)


def tuning_env(
    profile: str = "collective-overlap",
    base: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """The env additions for ``profile``, merged over ``base``
    (defaults to ``os.environ``). Pre-existing tokens win by
    construction -- a preset token whose name already appears in the
    existing value is dropped before merging -- EXCEPT for the override
    profiles (``_FORCE_PROFILES``), whose purpose is to flip a setting
    an earlier export made: there the preset wins and the conflicting
    existing token is dropped. Either way no token name appears twice."""
    if profile not in PROFILES:
        raise ValueError(
            f"unknown tuning profile {profile!r}; "
            f"available: {sorted(PROFILES)}"
        )
    force = profile in _FORCE_PROFILES
    src = dict(os.environ if base is None else base)
    out: Dict[str, str] = {}
    for var, value in PROFILES[profile].items():
        preset = _tokens(var, value)
        existing = _tokens(var, src.get(var, ""))
        if not existing:
            out[var] = _join(var, preset)
            continue
        if force:
            names = {_token_name(var, t) for t in preset}
            survivors = [t for t in existing
                         if _token_name(var, t) not in names]
            out[var] = _join(var, preset + survivors)
            continue
        user = {_token_name(var, t) for t in existing}
        kept = [t for t in preset if _token_name(var, t) not in user]
        out[var] = _join(var, kept + existing)
    return out


def _initialized() -> List[str]:
    """What has already read the environment in this process."""
    import torch
    import torch.distributed as dist

    done = []
    if torch.cuda.is_initialized():
        done.append("CUDA")
    if dist.is_available() and dist.is_initialized():
        done.append(f"the {dist.get_backend()} process group")
    return done


def apply_tuning(profile: str = "collective-overlap") -> Dict[str, str]:
    """Set the preset into ``os.environ``. Must run before CUDA
    initializes and before the process group is made: both read these
    variables exactly once."""
    done = _initialized()
    if done:
        raise RuntimeError(
            f"apply_tuning({profile!r}) called after {' and '.join(done)} "
            "initialized -- it has already read its settings. Call it "
            "before any CUDA use and before init_process_group (or export "
            "the env in the launcher: python -m "
            "tpu_hpc_torch.runtime.tuning --shell)."
        )
    env = tuning_env(profile)
    os.environ.update(env)
    return env


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", default="collective-overlap",
                   choices=sorted(PROFILES))
    p.add_argument("--shell", action="store_true",
                   help="print 'export VAR=...' lines for a launcher")
    args = p.parse_args(argv)
    env = tuning_env(args.profile)
    for var, val in env.items():
        if args.shell:
            print(f"export {var}='{val}'")
        else:
            print(f"{var}={val}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
