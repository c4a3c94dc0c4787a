"""Snapshots of a training run, the port of
vitcap_tpu/solver/checkpointing.py with the reference's layout:
`model_iter_{:07d}.ckpt` files in one directory, a `last_checkpoint`
pointer file naming the newest, and recover_or_load, which resumes from
the last snapshot and otherwise starts from a base model (a reference
`.pt` through solver.checkpoint_bridge, or a port `.ckpt`).

One torch-native backend.  A snapshot is one torch.save file of plain
containers and tensors:
- 'model': the model's state_dict (the reference's names without the
  leading 'module.', so a snapshot is also a `.pt` the bridge reads);
- 'opt': the AdamWState's step and its mu and nu moments by name;
- 'generator': the TrainState generator's get_state() (None without
  one) and 'generator_device' its device type;
- 'iteration'.
Writes are atomic (a temporary file, then os.replace); reads use
torch.load(weights_only=True) and put the tensors on the model's device,
so a snapshot saved on the card loads on the card.  The TPU package's
orbax backend and its async saves are JAX machinery: backend='orbax' and
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

import torch

from ..parallel.mesh import gather_state, shard_state
from .optimization import AdamWState
from .train_step import TrainState

SUFFIX = ".ckpt"


def save_state(path: str, state: Dict[str, Any]) -> None:
    """torch.save `state` to `path` atomically."""
    os.makedirs(op.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_state(path: str, device=None) -> Dict[str, Any]:
    """A snapshot's dict, its tensors on `device` (default: where they
    were saved from, as torch.load maps them)."""
    return torch.load(path, map_location=device, weights_only=True)


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
    from when None).  Gradients are turned on, as init_train_state does."""
    dev = next(model.parameters()).device
    model.load_state_dict(shard_state(model, snap["model"]), strict=True)
    opt = snap["opt"]
    mu = {n: t.to(dev) for n, t in shard_state(model, opt["mu"]).items()}
    nu = {n: t.to(dev) for n, t in shard_state(model, opt["nu"]).items()}
    if snap["generator"] is not None:
        if generator is None:
            generator = torch.Generator(device=snap["generator_device"])
        generator.set_state(snap["generator"].cpu())
    model.requires_grad_(True)
    return TrainState(model, AdamWState(int(opt["step"]), mu, nu), generator)


class Checkpointer:
    def __init__(self, save_dir: str, backend: str = "torch",
                 async_save: bool = False):
        if backend != "torch":
            raise ValueError(f"backend={backend!r}: the port has one "
                             f"backend, 'torch' (orbax is the TPU "
                             f"package's JAX format)")
        if async_save:
            raise ValueError("async_save is the TPU package's orbax "
                             "machinery; the port saves synchronously")
        self.save_dir = save_dir
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
        save_state(path, snapshot(state, iteration))
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
        save_state(path, snapshot(state, iteration))
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
        `.pt`/`.pth` through the bridge, or a port `.ckpt`) > `model` as
        it is.  A `.pt` load's report stays in self.load_report."""
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
                    model, load_state(basemodel, dev)["model"]), strict=True)
                logging.info("loaded port basemodel %s", basemodel)
        return model, None, 0
