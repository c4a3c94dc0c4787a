"""Run directories crossing between the JAX package and vitcap_tpu_torch
through the JAX package's default snapshot format (flax msgpack), on the
CPU, over test_torch_pipeline.py's tiny TSV dataset and parameters.

- The JAX package's `pipeline_train_eval_multi` trains 2 steps with its
  default `checkpoint_backend` (msgpack) and predicts; the port predicts
  from that snapshot (the same captions, confs rtol 1e-5), and resumes the
  directory for 2 more steps with the losses of the JAX package's own
  resume of it (rtol 2e-5, as test_torch_pipeline.py's losses).
- The reverse: a port run with `checkpoint_backend: msgpack`, whose
  snapshot the JAX package reads as its own (the same tree, step and
  iteration) and resumes with the losses of the port's resume of it.
Both resumes of a directory start fresh pipelines with the same seeded
tensorizer and transform RNGs, so their batches are the same.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import run as JR
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.pipelines import caption_pipeline as JCP
from vitcap_tpu.solver import checkpoint_bridge as JB
from vitcap_tpu.solver import checkpointing as JCK
from vitcap_tpu.solver import train_step as JTS

from test_torch_pipeline import (KEYS, TEST, _param, _predict_rows,
                                 make_dataset, seeded)
from vitcap_tpu_torch import run as TR
from vitcap_tpu_torch.pipelines import caption_pipeline as TCP
from vitcap_tpu_torch.solver import checkpoint_bridge as TB
from vitcap_tpu_torch.solver import checkpointing as TCk
from vitcap_tpu_torch.solver import train_step as TTS

SNAP = "model_iter_0000002.ckpt"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The dataset and a reference `.pt` basemodel (the JAX package's
    init_params), as test_torch_pipeline.py makes them."""
    root = str(tmp_path_factory.mktemp("resume"))
    make_dataset(root)
    jcfg = JCP.CaptionUniPipeline(**_param(root, "out_jax")).model_cfg
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(3), jcfg))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                JB.params_to_torch_state_dict(params).items()},
               os.path.join(root, "base.pt"))
    return root


def _snapshot_dir(param, expid="parity"):
    return os.path.join(param["output_root"], f"tinycoco_tiny_{expid}",
                        "snapshot")


def _two_steps(root, package, **kw):
    """`package`'s pipeline_train_eval_multi for 2 steps (one final
    snapshot at iteration 2): (its snapshot folder, its losses)."""
    losses = []
    param = _param(root, f"out_{package}2", max_iter=2, **kw)
    if package == "jax":
        with seeded(JCP, JTS, "make_jitted_train_step", losses):
            JR.pipeline_train_eval_multi(TEST, param)
    else:
        with seeded(TCP, TTS, "make_train_step", losses):
            TR.pipeline_train_eval_multi(TEST, dict(param, device="cpu"))
    assert len(losses) == 2
    return _snapshot_dir(param), losses


@pytest.fixture(scope="module")
def jax_dir(root):
    return _two_steps(root, "jax")


@pytest.fixture(scope="module")
def port_dir(root):
    return _two_steps(root, "port", checkpoint_backend="msgpack",
                      ignore_predict=True)


def _resume(root, src_snapshot, package, out):
    """Copy the iteration-2 snapshot of `src_snapshot` with a fresh
    pointer into a new run directory; `package` trains it to iteration 4
    there.  -> (the 2 losses, the new snapshot folder)."""
    param = _param(root, out, max_iter=4, snapshot_steps=10)
    snap = _snapshot_dir(param)
    os.makedirs(snap)
    shutil.copy(os.path.join(src_snapshot, SNAP), snap)
    with open(os.path.join(snap, "last_checkpoint"), "w") as f:
        f.write(os.path.join(snap, SNAP))
    losses = []
    if package == "jax":
        with seeded(JCP, JTS, "make_jitted_train_step", losses):
            JR.create_pipeline(param).ensure_train()
    else:
        with seeded(TCP, TTS, "make_train_step", losses):
            TR.create_pipeline(dict(param, device="cpu")).ensure_train()
    return losses, snap


def test_port_resumes_a_jax_run(root, jax_dir, tmp_path):
    """The port resumes a directory the JAX package wrote with its
    default backend: AdamW's step and moments come back (the resumed
    losses equal the JAX package's own resume's), and the final snapshot
    is at iteration 4, step 4."""
    src, _ = jax_dir
    assert not TCk.is_torch_file(os.path.join(src, SNAP))
    want, _ = _resume(root, src, "jax", str(tmp_path / "jax"))
    got, snap = _resume(root, src, "port", str(tmp_path / "port"))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-5)
    final = torch.load(os.path.join(snap, "model_iter_0000004.ckpt"),
                       weights_only=True)
    assert final["iteration"] == 4 and final["opt"]["step"] == 4


def test_port_predicts_from_a_jax_run(root, jax_dir, tmp_path):
    """The port's predict TSV from the JAX package's msgpack snapshot
    equals the JAX package's own: the same keys in order, captions equal,
    confs within rtol 1e-5."""
    src, _ = jax_dir
    param = dict(_param(root, str(tmp_path), max_iter=2), device="cpu")
    snap = _snapshot_dir(param)
    os.makedirs(snap)
    shutil.copy(os.path.join(src, SNAP), snap)
    results = TR.pipeline_eval_multi(TEST, param)
    assert results and "CIDEr" in results[0]
    want, got = _predict_rows(src), _predict_rows(snap)
    assert [k for k, _ in got] == [k for k, _ in want] == KEYS
    for (_, g), (_, w) in zip(got, want):
        assert [c["caption"] for c in g] == [c["caption"] for c in w]
        np.testing.assert_allclose([c["conf"] for c in g],
                                   [c["conf"] for c in w], rtol=1e-5)


def test_jax_reads_a_port_msgpack_snapshot(root, port_dir, jax_dir):
    """The JAX package's load_state reads the port's msgpack snapshot as
    one of its own: the same tree (lists and all) for params and both
    moments, the port's weights and moments leaf by leaf, step and
    iteration 2, and one more key, the generator's state."""
    path = os.path.join(port_dir[0], SNAP)
    assert not TCk.is_torch_file(path)
    got = JCK.load_state(path)
    ref = JCK.load_state(os.path.join(jax_dir[0], SNAP))
    assert set(got) == set(ref) | {"generator"}
    assert int(got["iteration"]) == int(ref["iteration"]) == 2
    assert int(got["opt"]["step"]) == 2
    for key in ("params", "mu", "nu"):
        a = got[key] if key == "params" else got["opt"][key]
        b = ref[key] if key == "params" else ref["opt"][key]
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(b)), key
    snap = TCk.load_state(path)
    for key, tree in (("model", got["params"]), ("mu", got["opt"]["mu"]),
                      ("nu", got["opt"]["nu"])):
        tensors = snap["model"] if key == "model" else snap["opt"][key]
        want = TB.state_to_jax_flat(tensors)
        flat = JB.flatten_params(tree)
        assert flat.keys() == want.keys()
        for p, w in want.items():
            np.testing.assert_array_equal(np.asarray(flat[p]), w,
                                          err_msg=p)
    assert got["generator"]["device"] == "cpu"
    assert got["generator"]["state"].dtype == np.uint8


def test_jax_resumes_a_port_msgpack_run(root, port_dir, tmp_path):
    """The JAX package resumes the port's `checkpoint_backend: msgpack`
    directory: its 2 resumed losses equal the port's own resume's."""
    src, _ = port_dir
    want, _ = _resume(root, src, "port", str(tmp_path / "port"))
    got, snap = _resume(root, src, "jax", str(tmp_path / "jax"))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-5)
    final = JCK.load_state(os.path.join(snap, "model_iter_0000004.ckpt"))
    assert int(final["iteration"]) == 4 and int(final["opt"]["step"]) == 4
