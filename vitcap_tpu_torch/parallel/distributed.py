"""Process-group bootstrap and host collectives, the port of
vitcap_tpu/parallel/distributed.py.

Where the JAX package starts one `jax.distributed` client a host, the port
runs one process a device and joins them in a torch.distributed process
group: NCCL when the rank's device is a card (the default), Gloo on the
CPU when the caller names it.  The address, world size and rank come from
the arguments or, as in the JAX package, from MASTER_ADDR / MASTER_PORT,
WORLD_SIZE and RANK (or OMPI_COMM_WORLD_*), which `python -m
torch.distributed.run` and mpirun set.
With one process every helper is the identity.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

DEFAULT_PORT = "29500"            # torch.distributed.run's default


def ensure_init_distributed(coordinator_address: Optional[str] = None,
                            num_processes: Optional[int] = None,
                            process_id: Optional[int] = None,
                            backend: Optional[str] = None,
                            device: Optional[torch.device] = None) -> None:
    """Idempotent process-group init.  A group the caller already made is
    left as it is; with no argument and no environment (one process),
    nothing happens.  coordinator_address: 'host:port'.  device: the
    rank's device, default the card ('cuda'); a card without one raises
    RuntimeError (as mesh.rank_device does), and the CPU is taken only
    when named.  backend: 'nccl' on a card, 'gloo' on the CPU; naming it
    overrides that (two ranks on one card need Gloo: NCCL refuses them).
    A card device becomes the current device first, so NCCL's
    communicator and the collectives' tensors live on it."""
    if dist.is_initialized():
        return
    env = os.environ
    coordinator_address = coordinator_address or (
        f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', DEFAULT_PORT)}"
        if "MASTER_ADDR" in env else None)
    num_processes = num_processes or int(
        env.get("WORLD_SIZE", env.get("OMPI_COMM_WORLD_SIZE", 0)) or 0) \
        or None
    process_id = process_id if process_id is not None else (
        int(env["RANK"]) if "RANK" in env else
        int(env["OMPI_COMM_WORLD_RANK"])
        if "OMPI_COMM_WORLD_RANK" in env else None)
    if coordinator_address is None and num_processes is None:
        logging.info("one process; no process group")
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            f"distributed init needs an address, a world size and a rank: "
            f"got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r} (set MASTER_ADDR/MASTER_PORT, WORLD_SIZE and "
            f"RANK, or launch with python -m torch.distributed.run)")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"distributed init on {device}: no CUDA device is "
                f"available; pass device='cpu' for a Gloo group on the CPU")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logging.info("torch.distributed initialized (%s): rank %d/%d", backend,
                 process_id, num_processes)


def world_size() -> int:
    """The group's size; 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def collective_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL, the
    CPU under Gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "barrier") -> None:
    """Host barrier (the reference's `synchronize`): a one-element
    all-reduce, which every backend runs on its own device."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1, device=collective_device()))


def any_process(flag: bool) -> bool:
    """Cross-process OR of a host-side bool (one process: identity).  Makes
    preemption collective: every rank stops at the same step boundary,
    else a peer hangs in the next step's gradient all-reduce."""
    if world_size() == 1:
        return flag
    t = torch.tensor([int(bool(flag))], device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_gather_host(values: Any) -> List[Any]:
    """Every rank's picklable `values`, in rank order (one process:
    [values])."""
    if world_size() == 1:
        return [values]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, values)
    return out


def shutdown() -> None:
    """Destroy the process group, if there is one, and forget its grid
    (parallel/mesh.py make_mesh)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    from . import mesh
    mesh._current = None
