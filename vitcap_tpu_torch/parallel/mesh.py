"""Data parallelism, the port of the data half of
vitcap_tpu/parallel/mesh.py.

The JAX package builds one mesh with a "data" axis and lets XLA insert the
gradient psum; the port runs one process a device (the PyTorch idiom:
`python -m torch.distributed.run --nproc_per_node N`) and does the three
things that mesh does by hand:
- every rank starts from rank 0's parameters (replicate_params);
- every rank takes its own rows of the global batch (the pipeline's
  DistributedSampler; local_rows for a batch in hand);
- the gradients are summed over the group in flat buckets
  (all_reduce_grads), after each rank scaled its loss so that the sum is
  the global batch's gradient (solver/train_step.py).
The Megatron tensor-parallel half of mesh.py is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import world_size


def rank_device(name: str, local_rank: int) -> torch.device:
    """A rank's device: 'cuda' -> cuda:<local_rank>, an explicit 'cuda:N'
    or 'cpu' as named.  Raises RuntimeError without a card, and where
    local_rank has no card: no wrap-around, no CPU."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: 'cuda', 'cuda:N' or 'cpu'")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r}: no CUDA device is available; set "
            f"'device: cpu' to run the pipeline on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {dev} (LOCAL_RANK {local_rank}): this host has "
            f"{torch.cuda.device_count()} CUDA device(s); launch at most "
            f"that many processes a host")
    return dev


def check_mesh_data(mesh_data: Optional[Any], world: int) -> None:
    """`mesh_data` must be unset or the number of processes: the port runs
    one process a device."""
    if mesh_data is not None and int(mesh_data) != world:
        raise ValueError(
            f"mesh_data: {mesh_data} with {world} process(es): the port runs "
            f"one process a device; launch {mesh_data} with python -m "
            f"torch.distributed.run --nproc_per_node {mesh_data} (or leave "
            f"mesh_data unset)")


def rank_seed(seed: int, rank: int, step: int = 0) -> int:
    """The seed of a rank's generators: `seed` itself on rank 0 at step 0
    (one rank draws what a run without a group draws), else a stream of
    (seed, rank, step)."""
    if rank == 0 and step == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank, step])
               .generate_state(1, np.uint64)[0] >> 1)


def replicate_params(model: torch.nn.Module, src: int = 0) -> None:
    """Broadcast `src`'s parameters and buffers to every rank, in place (at
    the start of training and after a resume)."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src)


def local_rows(batch: Dict[str, Any], rank: int, world: int
               ) -> Dict[str, Any]:
    """A rank's contiguous slice of a global batch's rows (every value with
    a leading batch axis; the row count must divide by `world`)."""
    n = {len(v) for v in batch.values()}
    if len(n) != 1 or next(iter(n)) % world:
        raise ValueError(f"local_rows: {n} rows over {world} ranks")
    per = next(iter(n)) // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def all_reduce_grads(grads: Dict[str, torch.Tensor],
                     extras: Optional[torch.Tensor] = None
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Optional[torch.Tensor]]:
    """SUM `grads` (name -> tensor) and the 1-D `extras` (metric sums that
    ride along) over the group: one flat bucket a dtype, one all-reduce
    each (also in a group of one, where it changes no bits).  Returns new
    tensors, views of the buckets; without a group, the arguments."""
    if not dist.is_initialized():
        return grads, extras
    names = list(grads)
    if extras is not None:
        names.append(None)
    groups: Dict[torch.dtype, List[Optional[str]]] = {}
    for n in names:
        t = extras if n is None else grads[n]
        groups.setdefault(t.dtype, []).append(n)
    out: Dict[str, torch.Tensor] = {}
    red_extras = None
    for members in groups.values():
        ts = [extras if n is None else grads[n] for n in members]
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        for n, t, piece in zip(members, ts,
                               flat.split([t.numel() for t in ts])):
            if n is None:
                red_extras = piece
            else:
                out[n] = piece.view(t.shape)
    return {n: out[n] for n in grads}, red_extras


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """A small tensor SUMmed over the group (a copy; without a group,
    itself)."""
    if not dist.is_initialized():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t
