"""The device grid, the port of vitcap_tpu/parallel/mesh.py: data
parallelism and Megatron tensor parallelism over a (data, model) grid of
processes.

The JAX package builds one mesh with ("data", "model") axes, annotates
shardings and lets XLA insert the collectives; the port runs one process a
device (the PyTorch idiom: `python -m torch.distributed.run
--nproc_per_node N`), builds the grid's process groups (make_mesh) and does
by hand what that mesh does:
- every rank starts from rank 0's parameters (replicate_params, in
  shard_params);
- every data rank takes its own rows of the global batch (the pipeline's
  DistributedSampler over data_rank() / data_size(); local_rows for a batch
  in hand); the ranks of one model group take the same rows;
- the gradients are summed over the data group in flat buckets
  (all_reduce_grads), after each rank scaled its loss so that the sum is
  the global batch's gradient (solver/train_step.py);
- with tensor_parallel=True, shard_params splits each transformer block
  over the model group by heads (param_partition_specs marks the leaves
  _leaf_spec marks in the JAX package): the fused qkv, q/k/v and fc1 by
  output rows (each rank keeps its heads' rows of q, k and v, and its
  MLP columns), the proj / out-dense and fc2 by input columns, everything
  else replicated.  The blocks then run on their local heads and sum their
  row-split products over the model group (parallel/tensor_parallel.py);
  gather_params rebuilds the unsplit state dict.
Rank r of the world is data index r // n_model and model index r %
n_model: the model axis is the fastest, as the JAX package's
np.array(devices).reshape(n_data, n_model) has it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import distributed
from .distributed import world_size
from .tensor_parallel import TPShard, all_gather, all_reduce_tp

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of processes: this rank's index on each axis
    and the process group of each (None without a process group)."""
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


_current: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    """The grid make_mesh made last in this process group, if any."""
    return _current if dist.is_initialized() else None


def data_rank() -> int:
    """This process's index on the data axis: the world rank without a
    grid."""
    mesh = current_mesh()
    return mesh.data_rank if mesh is not None else distributed.rank()


def data_size() -> int:
    """The data axis's size: the world size without a grid."""
    mesh = current_mesh()
    return mesh.n_data if mesh is not None else world_size()


def check_model_axis(n_model: int, num_heads: int,
                     intermediate_size: int) -> None:
    """n_model must divide the attention heads and the MLP width."""
    if n_model < 1 or num_heads % n_model or intermediate_size % n_model:
        raise ValueError(
            f"n_model={n_model} must divide the {num_heads} attention heads "
            f"and the MLP width {intermediate_size}")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              cfg=None) -> Mesh:
    """The (n_data, n_model) grid over the world group (n_data None: the
    world size over n_model).  Every rank must call it, in the same order
    as any other group it makes: it creates each model group (ranks
    [d n_model, (d + 1) n_model)) and each data group (ranks m, m +
    n_model, ...) with dist.new_group.  ValueError when n_data * n_model is
    not the world size, or (given the ModelConfig `cfg`) when n_model does
    not divide its heads or MLP width.  Without a process group the grid
    is (1, 1) and has no groups."""
    global _current
    world = world_size()
    if n_model < 1:
        raise ValueError(f"n_model={n_model} must be at least 1")
    if n_data is None:
        if world % n_model:
            raise ValueError(f"n_model={n_model} does not divide the "
                             f"world's {world} processes")
        n_data = world // n_model
    if n_data < 1 or n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) grid needs "
                         f"{n_data * n_model} processes; the world has "
                         f"{world}")
    if cfg is not None:
        check_model_axis(n_model, cfg.num_attention_heads,
                         cfg.intermediate_size)
    rank = distributed.rank()
    data_group = model_group = None
    if dist.is_initialized():
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = g
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = g
    _current = Mesh(n_data, n_model, rank // n_model, rank % n_model,
                    data_group, model_group)
    return _current


def mesh_of(model: torch.nn.Module) -> Optional[Mesh]:
    """The grid shard_params placed the model on, if any."""
    return model.__dict__.get("mesh")


# ---------------------------------------------------------------------------
# the partition rules (vitcap_tpu/parallel/mesh.py _leaf_spec)
# ---------------------------------------------------------------------------

_COLUMN = ("attn/qkv", "self/query", "self/key", "self/value", "mlp/fc1",
           "intermediate/dense")
_ROW = ("attn/proj", "attention/output/dense", "mlp/fc2", "output/dense")
# the transformer blocks that carry a TPShard: trunk, tag branch, decoder
_BLOCK = re.compile(r"bert\.(encoder\.(tag_)?blocks|decoder\.layer)\.\d+")


def _leaf_spec(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The spec of one parameter in the torch Linear layout (out, in),
    from its state-dict name by the JAX package's rules (the same
    substrings of the '/'-joined path): a column-split weight is split
    along its rows, (model, None), and its bias too, (model,); a row-split
    weight along its columns, (None, model); anything else, the row-split
    biases included, is replicated, ()."""
    path = name.replace(".", "/")
    if ndim == 2 and path.endswith("weight"):
        if any(k in path for k in _COLUMN):
            return (MODEL_AXIS, None)
        if any(k in path for k in _ROW):
            return (None, MODEL_AXIS)
    if ndim == 1 and path.endswith("bias") and any(k in path
                                                   for k in _COLUMN):
        return (MODEL_AXIS,)
    return ()


def param_partition_specs(model: torch.nn.Module
                          ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Every parameter's spec (name -> tuple, _leaf_spec), as the JAX
    package's param_partition_specs marks its leaves, in the torch
    layout: the JAX (in, out) kernel's P(None, 'model') is (model, None)
    here, P('model', None) is (None, model)."""
    return {n: _leaf_spec(n, p.dim()) for n, p in model.named_parameters()}


def _split_dims(model: torch.nn.Module) -> Dict[str, int]:
    """name -> split dimension of every leaf a tensor-parallel
    shard_params split ({} when the model is not split)."""
    if not model.__dict__.get("tensor_parallel"):
        return {}
    return {n: s.index(MODEL_AXIS)
            for n, s in param_partition_specs(model).items()
            if MODEL_AXIS in s}


def sharded_names(model: torch.nn.Module) -> List[str]:
    """The parameters a tensor-parallel shard_params split (none when the
    model is not split)."""
    return list(_split_dims(model))


def _fused_qkv(name: str) -> bool:
    return "attn.qkv." in name


def _shard(name: str, t: torch.Tensor, dim: int, n: int, r: int
           ) -> torch.Tensor:
    """Rank r's slice of the full tensor t along dim: the r-th of n equal
    blocks, or for the ViT's fused qkv the r-th block of each of q, k and
    v (the rank's heads in each), concatenated."""
    if _fused_qkv(name):
        parts = t.chunk(3, dim=0)
        return torch.cat([p.chunk(n, dim=0)[r] for p in parts])
    return t.chunk(n, dim=dim)[r]


def _unshard(name: str, parts: List[torch.Tensor], dim: int) -> torch.Tensor:
    """The inverse of _shard over every rank's slice, in rank order."""
    if _fused_qkv(name):
        per = [p.chunk(3, dim=0) for p in parts]
        return torch.cat([torch.cat([q[i] for q in per]) for i in range(3)])
    return torch.cat(parts, dim=dim)


def shard_params(model: torch.nn.Module, mesh: Mesh,
                 tensor_parallel: bool = False) -> torch.nn.Module:
    """Place a ViTCAP model on the grid, in place, after every rank has
    built or loaded the full model: every rank takes world rank 0's
    parameters (replicate_params); with tensor_parallel=True and a model
    axis past one, each rank then keeps its shard of every leaf
    param_partition_specs marks (_shard: by heads and MLP columns) and
    every transformer block records its TPShard (`tp`: the group, the
    rank's heads of the model's config (model.cfg) and their offset).
    Returns the model."""
    replicate_params(model)
    model.__dict__["mesh"] = mesh
    model.__dict__["tensor_parallel"] = False
    if not tensor_parallel or mesh.n_model == 1:
        return model
    cfg = model.cfg
    num_heads = cfg.num_attention_heads
    n, r = mesh.n_model, mesh.model_rank
    check_model_axis(n, num_heads, cfg.intermediate_size)
    model.__dict__["tensor_parallel"] = True
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, dim in _split_dims(model).items():
            p = params[name]
            if p.shape[dim] % (3 * n if _fused_qkv(name) else n):
                raise ValueError(f"shard_params: {name} {tuple(p.shape)} "
                                 f"does not split over {n} ranks")
            p.data = _shard(name, p.data, dim, n, r).contiguous()
    heads = num_heads // n
    shard = TPShard(mesh.model_group, n, r, heads, r * heads, num_heads)
    for name, mod in model.named_modules():
        if _BLOCK.fullmatch(name):
            mod.__dict__["tp"] = shard
        elif isinstance(mod, torch.nn.Linear):
            mod.out_features, mod.in_features = mod.weight.shape
    return model


def gather_state(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """`tensors` (parameter name -> this rank's tensor: the parameters, or
    Adam moments or gradients shaped like them, any subset) with every
    split leaf gathered over the model group into its unsplit layout; the
    others as they are.  Every rank of the model group must call it with
    the same names."""
    mesh = mesh_of(model)
    out = dict(tensors)
    for name, dim in _split_dims(model).items():
        if name in tensors:
            parts = all_gather(tensors[name].detach(), mesh.model_group,
                               mesh.n_model)
            out[name] = _unshard(name, parts, dim)
    return out


def gather_params(model: torch.nn.Module,
                  mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The model's full state dict in the unsplit layout, as new tensors
    (a split model's leaves gathered over the model group; `mesh` defaults
    to the model's).  Every rank of the model group must call it."""
    if mesh is not None and mesh_of(model) not in (None, mesh):
        raise ValueError("gather_params: the model lies on another grid")
    split = set(sharded_names(model))
    return {n: t if n in split else t.clone()
            for n, t in gather_state(model, model.state_dict()).items()}


def shard_state(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """Unsplit `tensors` (a state dict or moments by parameter name) cut to
    this rank's shard of a split model (as they are for a model that is
    not split): what loads into it."""
    mesh = mesh_of(model)
    out = dict(tensors)
    for name, dim in _split_dims(model).items():
        if name in out:
            out[name] = _shard(name, out[name], dim, mesh.n_model,
                               mesh.model_rank).contiguous()
    return out


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


def rank_seed(seed: int, rank: Optional[int] = None, step: int = 0) -> int:
    """The seed of a rank's generators: `seed` itself on rank 0 at step 0
    (one rank draws what a run without a group draws), else a stream of
    (seed, rank, step).  rank is the DATA rank (default data_rank()): the
    ranks of one model group hold replicated activations and must draw
    the same embedding-dropout and sampling masks."""
    if rank is None:
        rank = data_rank()
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


def local_rows(batch: Dict[str, Any], rank: Optional[int] = None,
               world: Optional[int] = None) -> Dict[str, Any]:
    """A data rank's contiguous slice of a global batch's rows (every value
    with a leading batch axis; the row count must divide by `world`).
    rank and world are the data axis's (default data_rank() and
    data_size()): the ranks of one model group take the same rows."""
    if rank is None:
        rank = data_rank()
    if world is None:
        world = data_size()
    n = {len(v) for v in batch.values()}
    if len(n) != 1 or next(iter(n)) % world:
        raise ValueError(f"local_rows: {n} rows over {world} ranks")
    per = next(iter(n)) // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def all_reduce_grads(grads: Dict[str, torch.Tensor],
                     extras: Optional[torch.Tensor] = None, group=None
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Optional[torch.Tensor]]:
    """SUM `grads` (name -> tensor) and the 1-D `extras` (metric sums that
    ride along) over `group` (the data group; None: the world): one flat
    bucket a dtype, one all-reduce each (also in a group of one, where it
    changes no bits).  Returns new tensors, views of the buckets; without
    a process group, the arguments."""
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
        dist.all_reduce(flat, group=group)
        for n, t, piece in zip(members, ts,
                               flat.split([t.numel() for t in ts])):
            if n is None:
                red_extras = piece
            else:
                out[n] = piece.view(t.shape)
    return {n: out[n] for n in grads}, red_extras


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """A small tensor SUMmed over `group` (None: the world; a copy; without
    a process group, itself)."""
    if not dist.is_initialized():
        return t
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def split_norm_args(model: torch.nn.Module):
    """(split leaves, their squared sum's reduction over the model group)
    for solver/optimization.py clip_by_global_norm; () for a model that is
    not split."""
    names = sharded_names(model)
    if not names:
        return ()
    mesh = mesh_of(model)
    tp = TPShard(mesh.model_group, mesh.n_model, mesh.model_rank, 0, 0, 0)
    return names, lambda sq: all_reduce_tp(sq, tp)
