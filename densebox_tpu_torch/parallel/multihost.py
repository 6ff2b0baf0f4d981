"""Process-group bootstrap (port of ``densebox_tpu/parallel/multihost.py``).

The port runs one process per device. ``torchrun`` (or any launcher that
sets the same variables) starts the processes; ``ensure_distributed`` joins
them into the default ``torch.distributed`` process group, after which
``parallel/mesh.py`` builds its data and model groups over it.

It reads torchrun's environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` (the ``env://`` rendezvous). The JAX
package's variables (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``, ``JAX_AUTO_DISTRIBUTED``) are not read. With nothing
configured it does nothing, so callers may call it unconditionally.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def default_backend(device=None) -> str:
    """NCCL for a CUDA device (``None`` is the card, as ``resolve_device``
    has it), gloo for any other."""
    if device is None or torch.device(device).type == "cuda":
        return "nccl"
    return "gloo"


def ensure_distributed(backend: Optional[str] = None, *, device=None,
                       init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> bool:
    """Join the default process group when a multi-process run is
    configured; return whether one is up.

    Resolution: explicit arguments, else torchrun's ``WORLD_SIZE`` and
    ``RANK`` (rendezvous ``env://`` at ``MASTER_ADDR:MASTER_PORT``); nothing
    configured (no ``WORLD_SIZE``, no arguments): a single process, nothing
    to do. ``backend`` defaults to ``default_backend(device)``; with NCCL the
    process's current CUDA device is set to ``local_device()`` first.

    Called again once the group is up, it checks the request against the
    group and raises ``RuntimeError`` when backend, world size or rank
    differ; a matching call is a no-op."""
    world_size = world_size if world_size is not None else _int_env(
        "WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    if world_size is None and init_method is None:
        if dist.is_available() and dist.is_initialized():
            _check_same(backend, device, None, None)
            return True
        return False
    backend = backend or default_backend(device)
    if dist.is_initialized():
        _check_same(backend, device, world_size, rank)
        return True
    if world_size is None or rank is None:
        raise ValueError(f"ensure_distributed: world size {world_size} and "
                         f"rank {rank} are both needed (torchrun sets "
                         f"WORLD_SIZE and RANK)")
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def _check_same(backend, device, world_size, rank) -> None:
    want = backend or (default_backend(device) if device is not None
                       else None)
    have = (dist.get_backend(), dist.get_world_size(), dist.get_rank())
    for name, w, h in zip(("backend", "world size", "rank"),
                          (want, world_size, rank), have):
        if w is not None and w != h:
            raise RuntimeError(
                f"ensure_distributed: the process group is already up with "
                f"{name} {h!r}, and this call asks for {w!r}")


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs: rank 0, or
    the only process when no group is up."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def world_size() -> int:
    """The number of processes of the default group, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def local_device() -> torch.device:
    """``cuda:LOCAL_RANK`` (``cuda:0`` without torchrun's variable): the
    card this process drives."""
    return torch.device("cuda", _int_env("LOCAL_RANK") or 0)


def run_processes(fn: Callable, nprocs: int, args: Sequence = (),
                  timeout: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new (spawned) processes and wait
    for them at most ``timeout`` seconds. Raises if one of them fails (the
    others are stopped) or if they are not done in time (all are killed),
    so a collective that hangs fails the caller instead of stalling it.
    ``fn`` and ``args`` must pickle; each process joins the process group
    itself (``init_process_group``)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} processes of {fn.__name__} "
                                   f"not done within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
