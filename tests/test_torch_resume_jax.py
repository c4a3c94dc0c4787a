"""Run directories crossing between the JAX package and vitcap_tpu_torch
through the JAX package's two snapshot formats, its default (flax
msgpack, `.ckpt` files) and orbax (`.orbax` directories), on the CPU,
over test_torch_pipeline.py's tiny TSV dataset and parameters.  Each test
runs for checkpoint_backend msgpack (its original name) and orbax (the
name with `orbax`).

- The JAX package's `pipeline_train_eval_multi` trains 2 steps with the
  backend and predicts; the port predicts from that snapshot (the same
  captions, confs rtol 1e-5), and resumes the directory for 2 more steps
  with the losses of the JAX package's own resume of it (rtol 2e-5, as
  test_torch_pipeline.py's losses).
- The reverse: a port run with the backend (orbax with
  `async_checkpoint: true`), whose snapshot the JAX package reads as its
  own (the same tree, step and iteration) and resumes with the losses of
  the port's resume of it.
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


def _snap(backend, it=2):
    return f"model_iter_{it:07d}{TCk.SUFFIXES[backend]}"


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
    out = f"out_{package}2" + ("orbax" if kw.get("checkpoint_backend")
                               == "orbax" else "")
    param = _param(root, out, max_iter=2, **kw)
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


@pytest.fixture(scope="module")
def jax_orbax_dir(root):
    return _two_steps(root, "jax", checkpoint_backend="orbax")


@pytest.fixture(scope="module")
def port_orbax_dir(root):
    return _two_steps(root, "port", checkpoint_backend="orbax",
                      async_checkpoint=True, ignore_predict=True)


def _copy_snapshot(src_snapshot, dst, backend):
    """The iteration-2 snapshot of `src_snapshot` into `dst` (made)."""
    os.makedirs(dst)
    name = _snap(backend)
    src = os.path.join(src_snapshot, name)
    if os.path.isdir(src):
        shutil.copytree(src, os.path.join(dst, name))
    else:
        shutil.copy(src, dst)
    return os.path.join(dst, name)


def _resume(root, src_snapshot, package, out, backend="msgpack"):
    """Copy the iteration-2 snapshot of `src_snapshot` with a fresh
    pointer into a new run directory; `package` trains it to iteration 4
    there, saving with its default backend (msgpack) or orbax.  -> (the
    2 losses, the new snapshot folder)."""
    kw = {"checkpoint_backend": "orbax"} if backend == "orbax" else {}
    param = _param(root, out, max_iter=4, snapshot_steps=10, **kw)
    snap = _snapshot_dir(param)
    copied = _copy_snapshot(src_snapshot, snap, backend)
    with open(os.path.join(snap, "last_checkpoint"), "w") as f:
        f.write(copied)
    losses = []
    if package == "jax":
        with seeded(JCP, JTS, "make_jitted_train_step", losses):
            JR.create_pipeline(param).ensure_train()
    else:
        with seeded(TCP, TTS, "make_train_step", losses):
            TR.create_pipeline(dict(param, device="cpu")).ensure_train()
    return losses, snap


def _port_resumes_a_jax_run(root, src, tmp_path, backend):
    if backend == "orbax":
        assert os.path.isdir(os.path.join(src, _snap(backend)))
    else:
        assert not TCk.is_torch_file(os.path.join(src, SNAP))
    want, _ = _resume(root, src, "jax", str(tmp_path / "jax"), backend)
    got, snap = _resume(root, src, "port", str(tmp_path / "port"), backend)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-5)
    final = os.path.join(snap, _snap(backend, 4))
    final = TCk.load_state(final) if backend == "orbax" else torch.load(
        final, weights_only=True)
    assert final["iteration"] == 4 and final["opt"]["step"] == 4


def test_port_resumes_a_jax_run(root, jax_dir, tmp_path):
    """The port resumes a directory the JAX package wrote with its
    default backend: AdamW's step and moments come back (the resumed
    losses equal the JAX package's own resume's), and the final snapshot
    is at iteration 4, step 4."""
    _port_resumes_a_jax_run(root, jax_dir[0], tmp_path, "msgpack")


def test_port_resumes_a_jax_orbax_run(root, jax_orbax_dir, tmp_path):
    """The same for a JAX run saved with `checkpoint_backend: orbax`."""
    _port_resumes_a_jax_run(root, jax_orbax_dir[0], tmp_path, "orbax")


def _port_predicts_from_a_jax_run(root, src, tmp_path, backend):
    kw = {"checkpoint_backend": "orbax"} if backend == "orbax" else {}
    param = dict(_param(root, str(tmp_path), max_iter=2, **kw),
                 device="cpu")
    snap = _snapshot_dir(param)
    _copy_snapshot(src, snap, backend)
    results = TR.pipeline_eval_multi(TEST, param)
    assert results and "CIDEr" in results[0]
    want, got = _predict_rows(src), _predict_rows(snap)
    assert [k for k, _ in got] == [k for k, _ in want] == KEYS
    for (_, g), (_, w) in zip(got, want):
        assert [c["caption"] for c in g] == [c["caption"] for c in w]
        np.testing.assert_allclose([c["conf"] for c in g],
                                   [c["conf"] for c in w], rtol=1e-5)


def test_port_predicts_from_a_jax_run(root, jax_dir, tmp_path):
    """The port's predict TSV from the JAX package's msgpack snapshot
    equals the JAX package's own: the same keys in order, captions equal,
    confs within rtol 1e-5."""
    _port_predicts_from_a_jax_run(root, jax_dir[0], tmp_path, "msgpack")


def test_port_predicts_from_a_jax_orbax_run(root, jax_orbax_dir, tmp_path):
    """The same from the JAX package's `.orbax` snapshot directory."""
    _port_predicts_from_a_jax_run(root, jax_orbax_dir[0], tmp_path,
                                  "orbax")


def _jax_reads_a_port_snapshot(port_src, jax_src, backend):
    path = os.path.join(port_src, _snap(backend))
    if backend == "orbax":
        assert os.path.isdir(path)
    else:
        assert not TCk.is_torch_file(path)
    got = JCK.load_state(path)
    ref = JCK.load_state(os.path.join(jax_src, _snap(backend)))
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
    if backend == "orbax":       # arrays only: the device as its code
        assert int(got["generator"]["device"]) == TCk.DEVICE_CODES["cpu"]
    else:
        assert got["generator"]["device"] == "cpu"
    assert np.asarray(got["generator"]["state"]).dtype == np.uint8
    assert snap["generator_device"] == "cpu"


def test_jax_reads_a_port_msgpack_snapshot(root, port_dir, jax_dir):
    """The JAX package's load_state reads the port's msgpack snapshot as
    one of its own: the same tree (lists and all) for params and both
    moments, the port's weights and moments leaf by leaf, step and
    iteration 2, and one more key, the generator's state."""
    _jax_reads_a_port_snapshot(port_dir[0], jax_dir[0], "msgpack")


def test_jax_reads_a_port_orbax_snapshot(root, port_orbax_dir,
                                         jax_orbax_dir):
    """The same for the port's `.orbax` directory (written by an async
    save), against the JAX package's own orbax snapshot."""
    _jax_reads_a_port_snapshot(port_orbax_dir[0], jax_orbax_dir[0],
                               "orbax")


def _jax_resumes_a_port_run(root, src, tmp_path, backend):
    want, _ = _resume(root, src, "port", str(tmp_path / "port"), backend)
    got, snap = _resume(root, src, "jax", str(tmp_path / "jax"), backend)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-5)
    final = JCK.load_state(os.path.join(snap, _snap(backend, 4)))
    assert int(final["iteration"]) == 4 and int(final["opt"]["step"]) == 4


def test_jax_resumes_a_port_msgpack_run(root, port_dir, tmp_path):
    """The JAX package resumes the port's `checkpoint_backend: msgpack`
    directory: its 2 resumed losses equal the port's own resume's."""
    _jax_resumes_a_port_run(root, port_dir[0], tmp_path, "msgpack")


def test_jax_resumes_a_port_orbax_run(root, port_orbax_dir, tmp_path):
    """The same for the port's `checkpoint_backend: orbax`,
    `async_checkpoint: true` directory."""
    _jax_resumes_a_port_run(root, port_orbax_dir[0], tmp_path, "orbax")
