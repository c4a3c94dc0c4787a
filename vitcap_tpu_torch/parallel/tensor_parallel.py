"""Megatron tensor parallelism's collectives, over the model axis of a
parallel/mesh.py grid.

A block split by shard_params carries a TPShard (its `tp` attribute): the
model axis's process group, this rank's place on it, and the attention
heads it runs.  A column-split product (qkv, fc1) needs no collective in
the forward: its output is the rank's heads or MLP columns.  A row-split
product (proj / out-dense, fc2) gives an f32 partial sum that is summed
over the group before its bias, residual and LayerNorm, which every rank
then computes on the same full activation.  In autograd form:
- copy_to_tp: identity forward, the gradient all-reduced backward (the
  input of a column-split product, whose gradient is partial);
- reduce_from_tp: all-reduce forward, identity backward (the output of a
  row-split product).
The train blocks' analytic backwards call all_reduce_tp themselves.  With
one rank on the model axis (or no shard) every function is the identity
and launches nothing.

The collectives run over the group's backend: NCCL, or Gloo, which also
takes CUDA tensors for all_reduce (two ranks on one card); all_gather_tp
stages a CUDA tensor through the host under Gloo, which has no CUDA
all_gather.  Every all-reduce goes through all_reduce_tp, whose calls,
bytes and host-clock seconds `stats` counts (the seconds only when
`timed` is set: timing synchronizes the device).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

# all_reduce_tp's calls, bytes and (when timed) seconds since the last reset
stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
timed = False


def reset_stats() -> None:
    stats.update(calls=0, bytes=0, seconds=0.0)


@dataclasses.dataclass(frozen=True)
class TPShard:
    """A split block's place on the model axis: the group, its size and
    this rank's index on it, and the attention heads it runs, [head_offset,
    head_offset + heads) of heads_total."""
    group: Any
    size: int
    rank: int
    heads: int
    head_offset: int
    heads_total: int


def tp_of(module) -> Optional[TPShard]:
    """The module's TPShard when it is split over more than one rank, else
    None (no shard, or a model axis of one)."""
    tp = module.__dict__.get("tp") if module is not None else None
    return tp if tp is not None and tp.size > 1 else None


def salt_heads(tp: Optional[TPShard]) -> Tuple[int, int]:
    """(nh_total, head_offset), the attention dropout's salt heads of a
    block's shard; (0, 0), the call's own heads, without one."""
    return (tp.heads_total, tp.head_offset) if tp is not None else (0, 0)


def local_heads(tp: Optional[TPShard], num_heads: int) -> int:
    """The heads a block runs: its shard's, or all `num_heads`."""
    return tp.heads if tp is not None else num_heads


def all_reduce_tp(t: torch.Tensor, tp: Optional[TPShard]) -> torch.Tensor:
    """SUM `t` over the model axis, in place; returns it (identity without
    a shard)."""
    if tp is None:
        return t
    stats["calls"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    if timed:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
    dist.all_reduce(t, group=tp.group)
    if timed:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        stats["seconds"] += time.perf_counter() - t0
    return t


def all_gather_tp(t: torch.Tensor, tp: Optional[TPShard], dim: int
                  ) -> torch.Tensor:
    """Every rank's `t` on the model axis concatenated along `dim`, in rank
    order (itself without a shard)."""
    if tp is None:
        return t
    return torch.cat(all_gather(t, tp.group, tp.size), dim=dim)


def all_gather(t: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    """Each of the group's `size` ranks' `t` (equal shapes), in rank order;
    a CUDA tensor under Gloo goes through the host."""
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    src = (t.cpu() if staged else t).contiguous()
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if staged else out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # summed in f32 (a copy: autograd may hand g to others too): the
        # ranks' partial input gradients of a column-split product
        return all_reduce_tp(g.to(torch.float32, copy=True),
                             ctx.tp).to(g.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_tp(x.clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TPShard]) -> torch.Tensor:
    """Identity forward; backward all-reduces the gradient over the model
    axis.  x itself without a shard."""
    return x if tp is None else _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: Optional[TPShard]) -> torch.Tensor:
    """All-reduce over the model axis forward (a new tensor); identity
    backward.  x itself without a shard."""
    return x if tp is None else _ReduceFromTP.apply(x, tp)
