"""Snapshots of a training run, the port of
vitcap_tpu/solver/checkpointing.py with the reference's layout:
`model_iter_{:07d}.ckpt` files (`.orbax` directories for the orbax
backend) in one directory, a `last_checkpoint` pointer file naming the
newest, and recover_or_load, which resumes from the last snapshot and
otherwise starts from a base model (a reference `.pt` through
solver.checkpoint_bridge, or a snapshot of any format).

Three backends write a snapshot; every format loads whatever the backend
is: a directory is orbax's, a file is told apart by its first bytes (a
zip, `PK\x03\x04`, is torch.save's; anything else is msgpack).
- 'torch' (the default): one torch.save file of plain containers and
  tensors: 'model', the model's state_dict (the reference's names without
  the leading 'module.', so a snapshot is also a `.pt` the bridge reads);
  'opt', the AdamWState's step and its mu and nu moments by name;
  'generator', the TrainState generator's get_state() (None without one)
  and 'generator_device' its device type; 'iteration'.  Read with
  torch.load(weights_only=True).
- 'msgpack': the JAX package's default format (flax msgpack,
  utils/msgpack_state.py): {'params', 'opt': {'step', 'mu', 'nu'},
  'iteration'} in the JAX tree and layout, f32 (checkpoint_bridge:
  dense kernels (in, out), the patch conv HWIO), plus one key the JAX
  package ignores, 'generator': {'state': the generator's uint8 state,
  'device': its device type}.  So the JAX package resumes a port run, and
  the port resumes a JAX run (no generator then: the caller's is kept).
- 'orbax': the JAX package's orbax directory (OCDBT + zarr v2 + zstd,
  utils/orbax_state.py, read and written without orbax): the msgpack
  backend's tree, every leaf an array, so the generator's device is an
  int32 code (DEVICE_CODES) that the JAX package's restore carries along.
load_state gives the torch layout's dict for any; its tensors are on
`device` (default: where a torch snapshot was saved from, the CPU for
msgpack and orbax), so a snapshot saved on the card loads on the card.
Writes are atomic (a temporary file or directory, then os.replace).

async_save=True (any backend; the JAX package's orbax option): save
returns once every tensor of the snapshot has been copied off the card
into a pinned host buffer the Checkpointer owns and reuses from save to
save (the copies synchronised, so the train step's in-place AdamW update
that follows cannot reach them), and a writer thread writes the file; the
pointer moves at save, as in the JAX package.  One save is in flight at a
time (the next save first waits for it); wait_until_finished joins it and
re-raises its error.

A tensor-parallel model (parallel/mesh.py shard_params) saves the unsplit
layout: snapshot gathers its split leaves and their Adam moments over the
model axis (parallel/mesh.py gather_state; every rank of the model group
calls it), so the file loads into an unsplit model; a load into a split
model cuts the unsplit tensors to the rank's shard (shard_state), so an
unsplit snapshot resumes a tensor-parallel run.
"""

from __future__ import annotations

import glob
import logging
import os
import os.path as op
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import gather_state, shard_state
from ..utils import msgpack_state, orbax_state
from . import checkpoint_bridge as bridge
from .optimization import AdamWState
from .train_step import TrainState

SUFFIXES = {"torch": ".ckpt", "msgpack": ".ckpt", "orbax": ".orbax"}
BACKENDS = tuple(SUFFIXES)
ZIP_MAGIC = b"PK\x03\x04"
DEVICE_CODES = {"cpu": 0, "cuda": 1}   # an orbax snapshot's generator device
DEVICE_NAMES = {v: k for k, v in DEVICE_CODES.items()}


def is_torch_file(path: str) -> bool:
    """Whether `path` is a torch.save zip (else a file is read as
    msgpack; a directory is orbax's)."""
    if op.isdir(path):
        return False
    with open(path, "rb") as f:
        return f.read(4) == ZIP_MAGIC


def to_jax_tree(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A snapshot dict (snapshot()'s) as the JAX package's state tree, as
    its Checkpointer writes it (step a 0-d int32 array, iteration a 0-d
    int64 one), f32 tensors in its layout (views; the writer copies them
    to the host one at a time)."""
    def tree(tensors):
        return bridge.unflatten_params(bridge.state_to_jax_tensors(tensors))
    opt = snap["opt"]
    out = {"params": tree(snap["model"]),
           "opt": {"step": np.asarray(opt["step"], np.int32),
                   "mu": tree(opt["mu"]), "nu": tree(opt["nu"])},
           "iteration": np.asarray(snap["iteration"], np.int64)}
    if snap.get("generator") is not None:
        out["generator"] = {"state": snap["generator"],
                            "device": snap["generator_device"]}
    return out


def _fresh(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of `t` on `device` (None: the CPU), owning its
    memory (not a view of the file's mapping).  A transposed view moves
    as the dense block it is (one plain copy), then is made contiguous
    there: on the card the transpose is the card's work, not the host's."""
    return t.to(device or "cpu", copy=True).contiguous()


def from_jax_tree(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's state tree (a msgpack snapshot's, or a bare param
    tree) as the torch backend's snapshot dict, tensors on `device`."""
    params = tree["params"] if "params" in tree else tree
    snap: Dict[str, Any] = {
        "model": {n: _fresh(t, device) for n, t in
                  bridge.port_state_dict(params).items()},
        "generator": None, "generator_device": None,
        "iteration": int(tree.get("iteration", 0))}
    if "opt" in tree:
        opt = tree["opt"]
        snap["opt"] = {"step": int(opt["step"]), **{
            k: {n: _fresh(t, device) for n, t in
                bridge.port_state_dict(opt[k]).items()}
            for k in ("mu", "nu")}}
    gen = tree.get("generator")
    if gen is not None:
        dev = gen["device"]
        if not isinstance(dev, str):          # an orbax snapshot's code
            code = int(dev)
            if code not in DEVICE_NAMES:
                raise ValueError(f"generator device code {code} (known: "
                                 f"{DEVICE_CODES})")
            dev = DEVICE_NAMES[code]
        snap["generator"] = gen["state"].clone()
        snap["generator_device"] = dev
    return snap


def to_orbax_tree(snap: Dict[str, Any]) -> Dict[str, Any]:
    """to_jax_tree with the generator's device as its int32 code: an orbax
    snapshot holds arrays only."""
    tree = to_jax_tree(snap)
    if "generator" in tree:
        dev = tree["generator"]["device"]
        if dev not in DEVICE_CODES:
            raise ValueError(f"generator on {dev!r}: an orbax snapshot "
                             f"codes {sorted(DEVICE_CODES)}")
        tree["generator"] = {"state": tree["generator"]["state"],
                             "device": np.asarray(DEVICE_CODES[dev],
                                                  np.int32)}
    return tree


def backend_tree(state: Dict[str, Any], backend: str) -> Dict[str, Any]:
    """What `backend` writes of a snapshot dict: the dict itself (torch),
    the JAX package's tree (msgpack) or that tree with arrays only
    (orbax)."""
    if backend == "msgpack":
        return to_jax_tree(state)
    if backend == "orbax":
        return to_orbax_tree(state)
    return state


def write_tree(path: str, tree: Dict[str, Any], backend: str) -> None:
    """Write backend_tree's output to `path` atomically."""
    if backend == "msgpack":
        msgpack_state.dump(path, tree)
    elif backend == "orbax":
        orbax_state.dump(path, tree)
    else:
        os.makedirs(op.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)


def save_state(path: str, state: Dict[str, Any],
               backend: str = "torch") -> None:
    """Write a snapshot dict to `path` atomically, in `backend`'s format."""
    write_tree(path, backend_tree(state, backend), backend)


def load_state(path: str, device=None) -> Dict[str, Any]:
    """A snapshot's dict (the torch layout, from any format), its tensors
    on `device` (default: where a torch snapshot's were saved from, as
    torch.load maps them; the CPU for msgpack and orbax)."""
    if op.isdir(path):
        return from_jax_tree(orbax_state.load(path), device)
    if is_torch_file(path):
        return torch.load(path, map_location=device, weights_only=True)
    return from_jax_tree(msgpack_state.load(path), device)


def load_model_state(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Only the weights of a snapshot of any format (or of a bare port
    state dict or JAX param tree), by port name; the optimizer moments are
    never read (an orbax snapshot's are not even decompressed).  A torch
    file's are CPU tensors over its mapping; a msgpack or orbax snapshot's
    are copied to `device` (default the CPU) in the torch layout."""
    if op.isdir(path):
        tree = orbax_state.load(path, only=("params",)) \
            or orbax_state.load(path)
    elif is_torch_file(path):
        state = torch.load(path, map_location="cpu", mmap=True,
                           weights_only=True)
        return state["model"] if "model" in state else state
    else:
        tree = msgpack_state.load(path)
    params = tree["params"] if "params" in tree else tree
    return {n: _fresh(t, device)
            for n, t in bridge.port_state_dict(params).items()}


def snapshot(state: TrainState, iteration: int) -> Dict[str, Any]:
    """The snapshot dict of a TrainState at `iteration`, in the unsplit
    layout (a tensor-parallel model's leaves and moments gathered)."""
    gen = state.generator
    model = state.model
    return {"model": gather_state(model, model.state_dict()),
            "opt": {"step": int(state.opt.step),
                    "mu": gather_state(model, state.opt.mu),
                    "nu": gather_state(model, state.opt.nu)},
            "generator": None if gen is None else gen.get_state(),
            "generator_device": None if gen is None else gen.device.type,
            "iteration": int(iteration)}


def restore_train_state(snap: Dict[str, Any], model: torch.nn.Module,
                        generator: Optional[torch.Generator] = None
                        ) -> TrainState:
    """A TrainState from a snapshot dict: the weights loaded into `model`
    (strictly, in place), the moments on the model's device, the
    generator's state set on `generator` (made on the device it was saved
    from when None), the moments in the model's parameter order, whatever
    the file's (a msgpack tree's is the JAX paths').  Gradients are turned
    on, as init_train_state does."""
    dev = next(model.parameters()).device
    model.load_state_dict(shard_state(model, snap["model"]), strict=True)
    opt = snap["opt"]
    names = [n for n, _ in model.named_parameters()]
    mu, nu = ({n: moments[n].to(dev) for n in names} for moments in (
        shard_state(model, opt["mu"]), shard_state(model, opt["nu"])))
    if snap["generator"] is not None:
        if generator is None:
            generator = torch.Generator(device=snap["generator_device"])
        generator.set_state(snap["generator"].cpu())
    model.requires_grad_(True)
    return TrainState(model, AdamWState(int(opt["step"]), mu, nu), generator)


def to_host(tree: Dict[str, Any], pinned: Optional[torch.Tensor] = None
            ) -> Tuple[Dict[str, Any], Optional[torch.Tensor]]:
    """A copy of a tree of dicts and lists whose tensors are contiguous CPU
    tensors
    owning their memory (never views of the model's or the optimizer's),
    every copy off the card complete when it returns.  A card tensor is
    made contiguous there (a transposed view of the JAX layout is
    transposed by the card) and lands in one pinned host buffer:
    `pinned` when it is large enough (a buffer an earlier call returned,
    free once that save finished), else a new one.  -> (the copy, the
    pinned buffer or None)."""
    cuda: list = []

    def find(x):
        if isinstance(x, (dict, list, tuple)):
            for v in (x.values() if isinstance(x, dict) else x):
                find(v)
        elif isinstance(x, torch.Tensor) and x.is_cuda:
            cuda.append(x)
    find(tree)
    sizes = [-(-t.numel() * t.element_size() // 64) * 64 for t in cuda]
    if cuda and (pinned is None or pinned.numel() < sum(sizes)):
        pinned = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
    views, off = {}, 0
    for t, n in zip(cuda, sizes):
        v = pinned[off:off + t.numel() * t.element_size()].view(t.dtype)
        views[id(t)] = v.view(t.shape).copy_(t.contiguous(),
                                             non_blocking=True)
        off += n

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        if isinstance(x, torch.Tensor):
            return views[id(x)] if x.is_cuda else x.detach().clone(
                memory_format=torch.contiguous_format)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x
    out = copy(tree)
    for dev in {t.device for t in cuda}:
        torch.cuda.synchronize(dev)
    return out, pinned


class Checkpointer:
    def __init__(self, save_dir: str, backend: str = "torch",
                 async_save: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"backend={backend!r}: the port writes "
                             f"{BACKENDS}")
        self.save_dir = save_dir
        self.backend = backend
        self.async_save = bool(async_save)
        self.load_report: Optional[Dict[str, Any]] = None  # the last .pt's
        self.last_blocking_s: Optional[float] = None   # the last save's
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Optional[torch.Tensor] = None   # async saves' buffer
        self._reserving: Optional[threading.Thread] = None
        os.makedirs(save_dir, exist_ok=True)

    @property
    def suffix(self) -> str:
        return SUFFIXES[self.backend]

    def checkpoint_path(self, iteration: int) -> str:
        return op.join(self.save_dir,
                       f"model_iter_{iteration:07d}{self.suffix}")

    @property
    def pointer_file(self) -> str:
        return op.join(self.save_dir, "last_checkpoint")

    def _write(self, path: str, state: TrainState, iteration: int) -> None:
        """Save now, or (async) hand host copies to a writer thread."""
        t0 = time.perf_counter()
        if not self.async_save:
            save_state(path, snapshot(state, iteration), self.backend)
            self.last_blocking_s = time.perf_counter() - t0
            return
        self.wait_until_finished()
        if self._reserving is not None:
            self._reserving.join()
            self._reserving = None
        host, self._pinned = to_host(
            backend_tree(snapshot(state, iteration), self.backend),
            self._pinned)

        def run():
            try:
                write_tree(path, host, self.backend)
                logging.info("async save of %s finished", path)
            except BaseException as e:      # re-raised by wait_until_finished
                self._error = e
        self._writer = threading.Thread(target=run, name="checkpoint-writer")
        self._writer.start()
        self.last_blocking_s = time.perf_counter() - t0

    def save(self, iteration: int, state: TrainState) -> str:
        """Write the snapshot (async: start writing it), then move the
        pointer to it."""
        path = self.checkpoint_path(iteration)
        self._write(path, state, iteration)
        with open(self.pointer_file + ".tmp", "w") as f:
            f.write(path)
        os.replace(self.pointer_file + ".tmp", self.pointer_file)
        logging.info("saved %s", path)
        return path

    def save_tagged(self, tag: str, iteration: int,
                    state: TrainState) -> str:
        """A diagnostic snapshot `<tag>.ckpt` (`.orbax`; e.g.
        NaN_context_<rank>) that leaves the pointer where it was: resume
        keeps to the last healthy snapshot."""
        path = op.join(self.save_dir, f"{tag}{self.suffix}")
        self._write(path, state, iteration)
        logging.info("saved tagged snapshot %s (pointer unchanged)", path)
        return path

    def reserve(self, model: torch.nn.Module
                ) -> Optional[threading.Thread]:
        """Async saves: allocate the pinned host buffer a snapshot of
        `model` needs (its state dict and both Adam moments) in a thread,
        so that the first save does not wait for it; recover_or_load
        calls it.  A snapshot that needs more (a tensor-parallel model's
        gathered leaves) allocates again at its save.  -> the thread
        (None: nothing to reserve)."""
        if not self.async_save or self._pinned is not None \
                or self._reserving is not None:
            return self._reserving
        tensors = [t for t in list(model.state_dict().values())
                   + 2 * list(model.parameters()) if t.is_cuda]
        if not tensors:
            return None
        n = sum(-(-t.numel() * t.element_size() // 64) * 64 for t in tensors)

        def run():
            self._pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        self._reserving = threading.Thread(target=run,
                                           name="checkpoint-pinned")
        self._reserving.start()
        return self._reserving

    def wait_until_finished(self) -> None:
        """Join the async save in flight, if any, and re-raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def has_checkpoint(self) -> bool:
        return op.isfile(self.pointer_file)

    def last_checkpoint(self) -> Optional[str]:
        """The snapshot the pointer names; if it is gone (an async save
        that never finished), the newest model_iter_* snapshot of any
        backend that exists; None without a pointer."""
        if not self.has_checkpoint():
            return None
        with open(self.pointer_file) as f:
            path = f.read().strip()
        if op.exists(path):
            return path
        done = sorted(glob.glob(op.join(self.save_dir, "model_iter_*.ckpt"))
                      + glob.glob(op.join(self.save_dir,
                                          "model_iter_*.orbax")))
        return done[-1] if done else None

    def recover_or_load(self, basemodel: Optional[str],
                        model: torch.nn.Module
                        ) -> Tuple[torch.nn.Module, Optional[Dict[str, Any]],
                                   int]:
        """(model, snapshot or None, start iteration).  Priority: the last
        snapshot (weights loaded into `model`; resume the rest with
        restore_train_state) > `basemodel`, weights only (a reference
        `.pt`/`.pth` through the bridge, or a snapshot of any format) >
        `model` as it is.  A `.pt` load's report stays in self.load_report.
        With async saves the pinned buffer is reserved meanwhile."""
        dev = next(model.parameters()).device
        self.reserve(model)
        last = self.last_checkpoint()
        if last:
            snap = load_state(last, dev)
            model.load_state_dict(shard_state(model, snap["model"]),
                                  strict=True)
            logging.info("recovered %s", last)
            return model, snap, int(snap.get("iteration", 0))
        if basemodel:
            if basemodel.endswith((".pt", ".pth")):
                from .checkpoint_bridge import (load_params_from_torch,
                                                load_torch_state_dict)
                _, report = load_params_from_torch(
                    model, load_torch_state_dict(basemodel))
                self.load_report = report
                logging.info(
                    "loaded torch basemodel %s (matched=%d missing=%d "
                    "mismatch=%d)", basemodel, len(report["matched"]),
                    len(report["missing"]), len(report["shape_mismatch"]))
            else:
                model.load_state_dict(shard_state(
                    model, load_model_state(basemodel, dev)), strict=True)
                logging.info("loaded basemodel %s", basemodel)
        return model, None, 0
