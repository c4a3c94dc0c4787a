"""The port's flax-msgpack codec (vitcap_tpu_torch/utils/msgpack_state.py)
and its msgpack snapshots (solver/checkpointing.py backend='msgpack')
against flax's serialization and the JAX package's checkpointing, on the
CPU.

Files cross both ways with every leaf, dtype (bf16 included), shape,
step and iteration equal; the port writes flax's bytes exactly; chunked
leaves (flax's MAX_CHUNK_SIZE patched inside a test) cross both ways;
malformed input raises ValueError naming a byte offset.  A msgpack
snapshot resumes bit for bit like a torch one, and a JAX train state
saved by the JAX package's Checkpointer restores the port's weights,
moments and step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.solver import checkpoint_bridge as JB
from vitcap_tpu.solver import checkpointing as JC

from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.solver import checkpoint_bridge as TB
from vitcap_tpu_torch.solver import checkpointing as TCk
from vitcap_tpu_torch.solver import train_step as TT
from vitcap_tpu_torch.utils import msgpack_state as MS

from test_torch_checkpointing import (HYPER, _assert_states_equal, _batch,
                                      _cfg, _fresh_state)

DTYPES = ["float32", "float16", "bfloat16", "int8", "int32", "int64",
          "uint8", "uint32", "bool"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _array(dtype, shape, seed):
    rs = np.random.RandomState(seed)
    if dtype == "bool":
        return np.asarray(rs.rand(*shape) < 0.5)
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(rs.randn(*shape), jnp.bfloat16))
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return np.asarray(rs.randint(max(info.min, -1000),
                                     min(info.max, 1000), size=shape),
                          dtype)
    return np.asarray(rs.randn(*shape), dtype)


def _tensor(a):
    """A numpy array (bf16 included) as a tensor of its dtype."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def _jax_tree(dtype):
    """A JAX-package state tree: params with block lists, the AdamW state,
    an np.int64 iteration, and leaves of `dtype` (a 0-d one too)."""
    return {
        "params": {"encoder": {"blocks": [
            {"w": _array("float32", (3, 5), 0), "x": _array(dtype, (4,), 1)},
            {"w": _array("float32", (3, 5), 2), "x": _array(dtype, (4,), 3)}]},
            "leaf": _array(dtype, (2, 3, 2), 4),
            "scalar": _array(dtype, (), 5), "empty": _array(dtype, (0, 3), 6)},
        "opt": {"step": np.asarray(jnp.asarray(7, jnp.int32)),
                "mu": {"m": _array("float32", (6,), 7)}},
        "iteration": np.int64(12),
    }


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    return t.numpy()


def _assert_same_tree(port, ref, path=""):
    """A tree the codec read (tensors, Python scalars) equals one flax
    read (numpy arrays and scalars): structure, dtypes, shapes, values."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and port.keys() == ref.keys(), path
        for k in ref:
            _assert_same_tree(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, torch.Tensor), path
        assert MS.NAMES[port.dtype] == ref.dtype.name, path
        assert tuple(port.shape) == ref.shape, path
        np.testing.assert_array_equal(_to_np(port), ref, err_msg=path)
    else:
        assert port == ref and not isinstance(port, torch.Tensor), path


# ---------------------------------------------------------------------------
# the codec against flax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_a_jax_save_state_file(tmp_path, dtype):
    """JAX's save_state file: every leaf, its dtype, step and iteration."""
    path = str(tmp_path / "s.ckpt")
    JC.save_state(path, _jax_tree(dtype))
    got = MS.load(path)
    _assert_same_tree(got, JC.load_state(path))
    assert int(got["iteration"]) == 12      # save_state: a 0-d array
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 7


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_reads_a_port_file(tmp_path, dtype):
    """The port's dump, read by JAX's load_state: the same tree, and the
    very bytes flax writes for it."""
    tree = _jax_tree(dtype)
    port = MS.loads(serialization.msgpack_serialize(tree))
    path = str(tmp_path / "p.ckpt")
    MS.dump(path, dict(port, iteration=np.int64(port["iteration"])))
    back = JC.load_state(path)
    _assert_same_tree(MS.load(path), back)
    assert isinstance(back["iteration"], np.int64)
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize(tree)
    assert not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("direction", ["jax_writes", "port_writes"])
def test_chunked_leaves_cross(tmp_path, monkeypatch, direction):
    """Leaves past MAX_CHUNK_SIZE (patched to 64 bytes on both sides for
    the test) are written as flax's __msgpack_chunked_array__ maps, in a
    map only (not under a list), and read back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(MS, "MAX_CHUNK_SIZE", 64)
    tree = {"a": {"big": _array("float32", (10, 7), 0),
                  "bf": _array("bfloat16", (5, 9), 1),
                  "small": _array("int32", (3,), 2)},
            "l": [_array("float32", (40,), 3)]}
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    path = str(tmp_path / "c.ckpt")
    if direction == "jax_writes":
        with open(path, "wb") as f:
            f.write(blob)
    else:
        MS.dump(path, {"a": {k: _tensor(v) for k, v in tree["a"].items()},
                       "l": [_tensor(tree["l"][0])]})
        with open(path, "rb") as f:
            assert f.read() == blob
    _assert_same_tree(MS.load(path), serialization.msgpack_restore(blob))


def _valid_blob():
    return serialization.msgpack_serialize(
        {"w": np.arange(6, dtype=np.float32).reshape(2, 3)})


@pytest.mark.parametrize("case", [
    "empty", "unused_type_byte", "unknown_ext", "unknown_dtype",
    "truncated", "trailing", "short_payload"])
def test_malformed_input_raises(tmp_path, case):
    """Malformed input raises ValueError naming the byte offset."""
    blob = _valid_blob()
    bad = {
        "empty": b"",
        "unused_type_byte": b"\xc1",
        "unknown_ext": b"\x81\xa1w\xd5\x07ab",
        "unknown_dtype": blob.replace(b"float32", b"float99"),
        "truncated": blob[:-5],
        "trailing": blob + b"\x00",
        # the bin header claims 24 bytes of a (2, 3) float32 array, but
        # the shape says (2, 2)
        "short_payload": blob.replace(b"\x92\x02\x03", b"\x92\x02\x02"),
    }[case]
    assert bad != blob
    path = tmp_path / "bad.ckpt"
    path.write_bytes(bad)
    with pytest.raises(ValueError, match=r"at byte \d+"):
        MS.load(str(path))


def test_arrays_are_views_of_the_mapping(tmp_path):
    """load builds each array over the file's mapping (no copy): two
    leaves lie as far apart in memory as their bytes in the file, and
    writing into the private mapping leaves the file as it was."""
    path = str(tmp_path / "v.ckpt")
    first = np.arange(1, 65, dtype=np.float32)
    second = first + 100.0
    JC.save_state(path, {"a": first, "b": second})
    with open(path, "rb") as f:
        blob = f.read()
    got = MS.load(path)
    a, b = got["a"], got["b"]
    assert b.data_ptr() - a.data_ptr() == (blob.index(second.tobytes())
                                           - blob.index(first.tobytes()))
    a.add_(1.0)
    np.testing.assert_array_equal(JC.load_state(path)["a"], first)


# ---------------------------------------------------------------------------
# msgpack snapshots
# ---------------------------------------------------------------------------

def test_msgpack_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """As test_torch_checkpointing.py's torch-backend case: dropout on, two
    steps, a msgpack snapshot, restore into a model initialised
    otherwise, one step: parameters, both moments, the step and the
    generator's state equal an uninterrupted three-step run's, bit for
    bit, and so do the third step's metrics."""
    cfg = _cfg()
    step = TT.make_train_step(cfg, HYPER)
    batches = [_batch(cfg, seed=i) for i in range(3)]
    ref = _fresh_state(cfg)
    for b in batches:
        ref, ref_m = step(ref, b)
    run = _fresh_state(cfg)
    for b in batches[:2]:
        run, _ = step(run, b)
    path = TCk.Checkpointer(str(tmp_path), backend="msgpack").save(2, run)
    assert not TCk.is_torch_file(path)
    model, snap, it = TCk.Checkpointer(str(tmp_path)).recover_or_load(
        None, TM.init_params(cfg, torch.Generator().manual_seed(99), "cpu"))
    assert it == 2 and snap["opt"]["step"] == 2
    resumed, m = step(TCk.restore_train_state(snap, model), batches[2])
    _assert_states_equal(resumed, ref)
    for k in ("loss", "grad_norm", "masked_loss", "tag_loss"):
        assert torch.equal(m[k], ref_m[k]), k


def test_msgpack_save_tagged_and_backends(tmp_path):
    """save_tagged writes msgpack too and leaves the pointer; the orbax
    backend and async saves, which raised before the port had them, now
    build (their round trips: test_torch_orbax.py); a backend neither
    package writes raises."""
    state = _fresh_state(TC.tiny_config())
    ck = TCk.Checkpointer(str(tmp_path), backend="msgpack")
    good = ck.save(4, state)
    tagged = ck.save_tagged("NaN_context_0", 5, state)
    assert ck.last_checkpoint() == good
    assert int(JC.load_state(tagged)["iteration"]) == 5
    assert TCk.Checkpointer(str(tmp_path), backend="orbax").suffix == \
        ".orbax"
    assert TCk.Checkpointer(str(tmp_path), backend="msgpack",
                            async_save=True).async_save
    with pytest.raises(ValueError, match="zarr3"):
        TCk.Checkpointer(str(tmp_path), backend="zarr3")


def _jax_train_state(seed):
    """The JAX package's state dict of a tiny model with random moments
    and step 6 (caption_pipeline._state_dict's layout)."""
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(seed),
                                   jax_tiny_config()))
    rs = np.random.RandomState(seed)

    def rand(a):
        return rs.randn(*a.shape).astype(np.float32)
    return {"params": params,
            "opt": {"step": np.asarray(jnp.asarray(6, jnp.int32)),
                    "mu": jax.tree_util.tree_map(rand, params),
                    "nu": jax.tree_util.tree_map(
                        lambda a: np.abs(rand(a)), params)}}


def test_a_jax_checkpointer_snapshot_restores_the_port_state(tmp_path):
    """The JAX package's Checkpointer snapshot (its default backend) read
    by the port's recover_or_load and restore_train_state: the weights
    and both moments equal the JAX leaves under the bridge's layout, the
    step and iteration equal, no generator (the caller's is kept)."""
    jstate = _jax_train_state(2)
    JC.Checkpointer(str(tmp_path)).save(9, jstate)
    cfg = TC.tiny_config()
    model, snap, it = TCk.Checkpointer(str(tmp_path)).recover_or_load(
        None, TM.init_params(cfg, torch.Generator().manual_seed(5), "cpu"))
    assert it == 9 and snap["generator"] is None
    gen = torch.Generator().manual_seed(3)
    gen_state = gen.get_state()
    state = TCk.restore_train_state(snap, model, gen)
    assert state.opt.step == 6 and state.generator is gen
    assert torch.equal(gen.get_state(), gen_state)
    for name, tensors, tree in (
            ("params", dict(state.model.named_parameters()),
             jstate["params"]),
            ("mu", state.opt.mu, jstate["opt"]["mu"]),
            ("nu", state.opt.nu, jstate["opt"]["nu"])):
        got, want = TB.state_to_jax_flat(tensors), JB.flatten_params(tree)
        assert got.keys() == want.keys(), name
        for p in want:
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_a_jax_params_only_ckpt_is_a_basemodel(tmp_path):
    """A `.ckpt` of the JAX package's save_state({'params': ...}) as the
    basemodel: the weights only, iteration 0 (the JAX package's rule)."""
    jstate = _jax_train_state(4)
    path = str(tmp_path / "base.ckpt")
    JC.save_state(path, {"params": jstate["params"]})
    model, snap, it = TCk.Checkpointer(str(tmp_path / "run")).recover_or_load(
        path, TM.init_params(TC.tiny_config(),
                             torch.Generator().manual_seed(5), "cpu"))
    assert snap is None and it == 0
    got = TB.state_to_jax_flat(dict(model.named_parameters()))
    want = JB.flatten_params(jstate["params"])
    assert got.keys() == want.keys()
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
