"""Snapshots of a training run, the port of
vitcap_tpu/solver/checkpointing.py with the reference's layout:
`model_iter_{:07d}.ckpt` files in one directory, a `last_checkpoint`
pointer file naming the newest, and recover_or_load, which resumes from
the last snapshot and otherwise starts from a base model (a reference
`.pt` through solver.checkpoint_bridge, or a `.ckpt` of either format).

Two backends write a snapshot; both formats load whatever the backend
is, told apart by their first bytes (a zip, `PK\x03\x04`, is
torch.save's; anything else is msgpack).
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
load_state gives the torch layout's dict for either; its tensors are on
`device` (default: where a torch snapshot was saved from, the CPU for
msgpack), so a snapshot saved on the card loads on the card.  Writes are
atomic (a temporary file, then os.replace).  The JAX package's orbax
backend and its async saves are JAX machinery: backend='orbax' and
async_save=True raise ValueError.

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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import gather_state, shard_state
from ..utils import msgpack_state
from . import checkpoint_bridge as bridge
from .optimization import AdamWState
from .train_step import TrainState

SUFFIX = ".ckpt"
BACKENDS = ("torch", "msgpack")
ZIP_MAGIC = b"PK\x03\x04"


def is_torch_file(path: str) -> bool:
    """Whether `path` is a torch.save zip (else it is read as msgpack)."""
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
        snap["generator"] = gen["state"].clone()
        snap["generator_device"] = gen["device"]
    return snap


def save_state(path: str, state: Dict[str, Any],
               backend: str = "torch") -> None:
    """Write a snapshot dict to `path` atomically, in `backend`'s format."""
    if backend == "msgpack":
        msgpack_state.dump(path, to_jax_tree(state))
        return
    os.makedirs(op.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_state(path: str, device=None) -> Dict[str, Any]:
    """A snapshot's dict (the torch layout, from either format), its
    tensors on `device` (default: where a torch snapshot's were saved
    from, as torch.load maps them; the CPU for msgpack)."""
    if is_torch_file(path):
        return torch.load(path, map_location=device, weights_only=True)
    return from_jax_tree(msgpack_state.load(path), device)


def load_model_state(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Only the weights of a snapshot of either format (or of a bare port
    state dict), by port name; the optimizer moments are never read.  A
    torch file's are CPU tensors over its mapping; a msgpack file's are
    copied to `device` (default the CPU) in the torch layout."""
    if is_torch_file(path):
        state = torch.load(path, map_location="cpu", mmap=True,
                           weights_only=True)
        return state["model"] if "model" in state else state
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


class Checkpointer:
    def __init__(self, save_dir: str, backend: str = "torch",
                 async_save: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"backend={backend!r}: the port writes "
                             f"{BACKENDS} (orbax is the TPU package's "
                             f"JAX machinery)")
        if async_save:
            raise ValueError("async_save is the TPU package's orbax "
                             "machinery; the port saves synchronously")
        self.save_dir = save_dir
        self.backend = backend
        self.load_report: Optional[Dict[str, Any]] = None  # the last .pt's
        os.makedirs(save_dir, exist_ok=True)

    def checkpoint_path(self, iteration: int) -> str:
        return op.join(self.save_dir, f"model_iter_{iteration:07d}{SUFFIX}")

    @property
    def pointer_file(self) -> str:
        return op.join(self.save_dir, "last_checkpoint")

    def save(self, iteration: int, state: TrainState) -> str:
        """Write the snapshot, then move the pointer to it."""
        path = self.checkpoint_path(iteration)
        save_state(path, snapshot(state, iteration), self.backend)
        with open(self.pointer_file + ".tmp", "w") as f:
            f.write(path)
        os.replace(self.pointer_file + ".tmp", self.pointer_file)
        logging.info("saved %s", path)
        return path

    def save_tagged(self, tag: str, iteration: int,
                    state: TrainState) -> str:
        """A diagnostic snapshot `<tag>.ckpt` (e.g. NaN_context_<rank>)
        that leaves the pointer where it was: resume keeps to the last
        healthy snapshot."""
        path = op.join(self.save_dir, f"{tag}{SUFFIX}")
        save_state(path, snapshot(state, iteration), self.backend)
        logging.info("saved tagged snapshot %s (pointer unchanged)", path)
        return path

    def has_checkpoint(self) -> bool:
        return op.isfile(self.pointer_file)

    def last_checkpoint(self) -> Optional[str]:
        """The file the pointer names; if it is gone, the newest
        model_iter_* snapshot that exists; None without a pointer."""
        if not self.has_checkpoint():
            return None
        with open(self.pointer_file) as f:
            path = f.read().strip()
        if op.exists(path):
            return path
        done = sorted(glob.glob(op.join(self.save_dir,
                                        f"model_iter_*{SUFFIX}")))
        return done[-1] if done else None

    def recover_or_load(self, basemodel: Optional[str],
                        model: torch.nn.Module
                        ) -> Tuple[torch.nn.Module, Optional[Dict[str, Any]],
                                   int]:
        """(model, snapshot or None, start iteration).  Priority: the last
        snapshot (weights loaded into `model`; resume the rest with
        restore_train_state) > `basemodel`, weights only (a reference
        `.pt`/`.pth` through the bridge, or a `.ckpt` of either format) >
        `model` as it is.  A `.pt` load's report stays in self.load_report."""
        dev = next(model.parameters()).device
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
