"""vitcap_tpu_torch's orbax snapshots (utils/orbax_state.py, native/zstd.cpp,
the orbax backend and async saves of solver/checkpointing.py), on the CPU.

orbax, tensorstore and zstandard run only on this side, to write what the
port must read and to read what it writes:
- the hand-written zstd decoder against zstandard's frames at every level
  (with and without content size and checksum, concatenated, skippable),
  and on corrupted input, which raises ValueError;
- leaves the JAX package's Checkpointer(backend="orbax") saves (f32,
  bf16, i32, i64, u8; 0-d, 1-d, 2-d; random, all zeros, repeated rows,
  small-range integers) decode bit-equal to its load_state, and so do
  arrays sharded over the conftest's CPU devices (several chunks) and
  zarr arrays with partial edge chunks and fill values;
- a port-written directory is restored by the JAX package as its own;
- bad input raises ValueError naming the file;
- the committed fixture (tests/data/orbax_jax_tiny, written by
  tests/make_orbax_fixture.py) decodes bit-equal to its msgpack twin, its
  frames hold every block kind, and a regenerated fixture decodes to the
  same values;
- the orbax backend resumes bit-equal to the torch backend, and an async
  save holds the state of its call even when a train step runs before it
  finishes.
The decoder is built with the host's g++ (no card, nothing skipped).
"""

import json
import os
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from vitcap_tpu.solver import checkpoint_bridge as JB
from vitcap_tpu.solver import checkpointing as JCK

from vitcap_tpu_torch import native
from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.solver import checkpointing as TCk
from vitcap_tpu_torch.solver import train_step as TT
from vitcap_tpu_torch.utils import msgpack_state
from vitcap_tpu_torch.utils import orbax_state as O

from test_torch_checkpointing import _batch, _fresh_state

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "orbax_jax_tiny")


def _np(x) -> np.ndarray:
    """A leaf as numpy, bf16 as its int16 bits (bit-equality)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(got, want, path=""):
    """Same tree (dicts, lists), and leaves of the same shape and dtype,
    bit-equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}/{i}")
    else:
        g, w = _np(got), _np(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


def _jax_save(tmp, tree, iteration=1):
    return JCK.Checkpointer(str(tmp), backend="orbax").save(iteration, tree)


def _decode(frame: bytes, n: int, counts=None) -> bytes:
    out = np.empty(n, np.uint8)
    O.zstd_decode_into(frame, out, "test", counts)
    return out.tobytes()


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def test_zstd_source_links_no_library():
    """zstd.cpp includes no zstd header and links no library; the port's
    build gives it no extra flags."""
    src = (native.SOURCES / "zstd.cpp").read_text()
    assert "zstd.h" not in [line.split("<")[-1].split('"')[-1].rstrip('>"')
                            for line in src.splitlines()
                            if line.startswith("#include")]
    assert "zstd" not in native.LIBS
    assert "-lzstd" not in " ".join(native.CXX_FLAGS)


CORPUS = {
    "empty": b"",
    "byte": b"x",
    "text": (native.SOURCES / "cider.cpp").read_bytes(),
    "zeros": bytes(300_000),
    "f32": np.random.RandomState(0).standard_normal(90_000)
    .astype(np.float32).tobytes(),
    "small_ints": np.random.RandomState(1).randint(0, 5, 60_000)
    .astype(np.int32).tobytes(),
    "random": np.random.RandomState(2).randint(0, 256, 140_000)
    .astype(np.uint8).tobytes(),
    "rows": np.tile(np.random.RandomState(3).standard_normal(97)
                    .astype(np.float32), 900).tobytes(),
}


@pytest.mark.parametrize("level", [-3, 1, 3, 9, 19])
def test_zstd_matches_zstandard(level):
    """Every corpus entry, with and without a content size and checksum,
    decodes to its bytes; counters see each kind the level produces (the
    negative levels leave literals raw)."""
    counts = np.zeros(len(O.COUNTERS), np.uint64)
    for name, data in CORPUS.items():
        for fcs in (True, False):
            for check in (False, True):
                z = zstandard.ZstdCompressor(
                    level=level, write_content_size=fcs,
                    write_checksum=check).compress(data)
                assert _decode(z, len(data), counts) == data, (name, fcs)
    c = dict(zip(O.COUNTERS, counts.tolist()))
    assert c["frames"] == 4 * len(CORPUS) and c["checksums"] == 2 * len(
        CORPUS)
    assert c["raw_blocks"] and c["compressed_blocks"]
    assert c["sequences"] > 0
    if level > 0:
        assert c["literals_huffman"] and c["literals_4_streams"]


def test_zstd_streams_concatenation_and_skippable_frames():
    """A streamed frame (no content size, several blocks, RLE blocks after
    the first), two concatenated frames and a skippable frame between
    them; a long-distance match window."""
    data = CORPUS["text"] * 40 + bytes(400_000)
    co = zstandard.ZstdCompressor(level=5).compressobj()
    z = co.compress(data) + co.flush()
    counts = np.zeros(len(O.COUNTERS), np.uint64)
    assert _decode(z, len(data), counts) == data
    assert dict(zip(O.COUNTERS, counts.tolist()))["rle_blocks"] > 0
    skip = struct.pack("<II", 0x184D2A5E, 3) + b"abc"
    two = (zstandard.ZstdCompressor(level=1).compress(data[:5000]) + skip
           + zstandard.ZstdCompressor(level=12).compress(data[5000:9000]))
    assert _decode(two, 9000) == data[:9000]
    big = np.random.RandomState(4).randint(0, 256, 3 << 20) \
        .astype(np.uint8).tobytes()
    big = big + big[: 1 << 20]
    params = zstandard.ZstdCompressionParameters.from_level(
        5, window_log=23, enable_ldm=True)
    z = zstandard.ZstdCompressor(compression_params=params).compress(big)
    assert _decode(z, len(big)) == big


def test_zstd_raw_frames_the_writer_makes():
    """The writer's frames (raw blocks, 128 KiB window, content size)
    are zstd that zstandard reads, and the port's decoder too."""
    for n in (0, 1, 131072, 131073, 400_000):
        data = np.random.RandomState(n % 7).randint(0, 256, n) \
            .astype(np.uint8).tobytes()
        frame = O.zstd_raw_header(n) + b"".join(
            h + data[s:e] for s, e, h in O.zstd_raw_blocks(n))
        assert zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=max(n, 1)) == data
        assert _decode(frame, n) == data


def test_zstd_rejects_malformed_input():
    """Truncated frames, flipped bytes, a wrong size and a bad checksum
    raise ValueError (with a byte offset); none crashes."""
    data = CORPUS["text"] * 3
    z = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    with pytest.raises(ValueError, match="at byte"):
        _decode(z[:len(z) // 2], len(data))
    with pytest.raises(ValueError, match="expected"):
        _decode(z, len(data) + 1)
    bad = bytearray(z)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        _decode(bytes(bad), len(data))
    with pytest.raises(ValueError, match="not a zstd frame"):
        _decode(b"\x00" * 16, 16)
    rs = np.random.RandomState(5)
    raised = 0
    for i in range(400):
        bad = bytearray(z)
        for _ in range(1 + i % 3):
            bad[rs.randint(0, len(bad))] = rs.randint(0, 256)
        try:
            _decode(bytes(bad), len(data))
        except ValueError:
            raised += 1
    assert raised > 300


def test_crc32c_known_value():
    assert O.crc32c(b"123456789") == 0xE3069283


# ---------------------------------------------------------------------------
# JAX-written snapshots
# ---------------------------------------------------------------------------

_DTYPES = [np.float32, jnp.bfloat16, np.int32, np.int64, np.uint8]


@st.composite
def _leaf(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    ndim = draw(st.integers(0, 2))
    shape = tuple(draw(st.lists(st.integers(1, 70), min_size=ndim,
                                max_size=ndim)))
    kind = draw(st.sampled_from(["random", "zeros", "rows", "small"]))
    rs = np.random.RandomState(draw(st.integers(0, 2 ** 31 - 1)))
    n = int(np.prod(shape))
    if kind == "zeros":
        a = np.zeros(n)
    elif kind == "small":
        a = rs.randint(0, 4, n)
    elif kind == "rows" and ndim == 2:
        a = np.tile(rs.standard_normal(shape[1]) * 50, shape[0])
    else:
        a = rs.standard_normal(n) * 100
    if np.dtype(dtype).kind in "iu":
        a = np.clip(np.round(a), 0 if dtype == np.uint8 else -1e9,
                    255 if dtype == np.uint8 else 1e9)
    return np.asarray(a.astype(dtype)).reshape(shape)


@settings(max_examples=20, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(leaves=st.lists(_leaf(), min_size=1, max_size=5))
def test_jax_written_leaves_decode_bit_equal(tmp_path_factory, leaves):
    """orbax_state.load gives every leaf bit-equal to the JAX package's
    load_state (numpy leaves and jax.Array leaves alike)."""
    tmp = tmp_path_factory.mktemp("leaves")
    tree = {"params": {f"l{i}": (jnp.asarray(a) if i % 2 else a)
                       for i, a in enumerate(leaves)},
            "opt": {"step": np.int32(3)}}
    path = _jax_save(tmp, tree)
    _same(O.load(path), JCK.load_state(path))
    only = O.load(path, only=("params",))
    assert set(only) == {"params"}


def test_structured_leaves_cover_every_block_kind(tmp_path):
    """Random, all-zero, repeated-row and small-integer leaves large
    enough for several blocks: raw, RLE and compressed blocks, Huffman
    literals and FSE-coded sequences all occur, and decode bit-equal."""
    rs = np.random.RandomState(0)
    row = rs.standard_normal(200).astype(np.float32)
    tree = {"zeros": np.zeros((300, 300), np.float32),
            "rows": np.tile(row, (300, 1)),
            "random": rs.randint(0, 256, 200_000).astype(np.uint8),
            "small": rs.randint(0, 4, (200, 300)).astype(np.int64),
            "f32": rs.standard_normal((200, 300)).astype(np.float32),
            "bf16": jnp.asarray(rs.standard_normal((100, 30)),
                                jnp.bfloat16),
            "scalar": np.int32(-5)}
    path = _jax_save(tmp_path, tree)
    _same(O.load(path), JCK.load_state(path))
    counts = np.zeros(len(O.COUNTERS), np.uint64)
    for key, src, n in O.chunk_frames(path):
        O.zstd_decode_into(src, np.empty(n, np.uint8), key, counts)
    c = dict(zip(O.COUNTERS, counts.tolist()))
    for kind in ("raw_blocks", "rle_blocks", "compressed_blocks",
                 "literals_huffman", "sequences_fse", "sequences"):
        assert c[kind] > 0, (kind, c)


@pytest.mark.parametrize("spec", [(None, "model"), ("data", "model")])
def test_sharded_arrays_assemble_from_chunks(tmp_path, spec):
    """An array sharded over a 2 x 2 mesh of the conftest's CPU devices is
    saved as several chunks (orbax splits the replicated axis too); load
    assembles them bit-equal."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    a = np.arange(64 * 8, dtype=np.float32).reshape(64, 8) * 0.5
    x = jax.device_put(a, NamedSharding(mesh, P(*spec)))
    path = _jax_save(tmp_path, {"params": {"w": x}})
    keys = [k for k, _, _ in O.chunk_frames(path)
            if k.startswith("params.w/")]
    zarray = json.loads(bytes(O._Database(path).value("params.w/.zarray")))
    assert zarray["chunks"][1] == 4
    assert len(keys) == (64 // zarray["chunks"][0]) * 2 > 2
    got = O.load(path)["params"]["w"]
    np.testing.assert_array_equal(got.numpy(), a)
    _same(O.load(path), JCK.load_state(path))


def _zarr_snapshot(path, arrays, fill=None, skip_fill_chunks=False):
    """A snapshot directory of zarr v2 arrays with chosen chunk grids in
    an OCDBT database, written with tensorstore, and its _METADATA."""
    os.makedirs(path)
    md = {}
    for name, (a, chunks) in arrays.items():
        t = ts.open({
            "driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{path}/",
                        "path": f"params.{name}/"},
            "metadata": {"shape": list(a.shape), "chunks": chunks,
                         "dtype": a.dtype.str, "fill_value": fill,
                         "compressor": {"id": "zstd", "level": 1}},
            "create": True,
            "store_data_equal_to_fill_value": not skip_fill_chunks,
        }).result()
        t.write(a).result()
        md[str(("params", name))] = {
            "key_metadata": [{"key": "params", "key_type": 2},
                             {"key": name, "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": md, "use_ocdbt": True,
                   "use_zarr3": False}, f)


def test_partial_edge_chunks_and_fill_values(tmp_path):
    """zarr v2 edge chunks are full-size: a (10, 7) array in (3, 5) chunks
    and a (9,) one in 4s assemble; chunks equal to the fill value that
    were not stored come back as the fill value."""
    rs = np.random.RandomState(0)
    a = rs.standard_normal((10, 7)).astype(np.float32)
    b = rs.randint(0, 100, 9).astype(np.int64)
    c = np.zeros((8, 8), np.int32)
    c[:4, :4] = 7
    path = str(tmp_path / "snap")
    _zarr_snapshot(path, {"a": (a, [3, 5]), "b": (b, [4]),
                          "c": (c, [4, 4])}, fill=0, skip_fill_chunks=True)
    got = O.load(path)["params"]
    np.testing.assert_array_equal(got["a"].numpy(), a)
    np.testing.assert_array_equal(got["b"].numpy(), b)
    np.testing.assert_array_equal(got["c"].numpy(), c)
    assert len([k for k, _, _ in O.chunk_frames(path)
                if k.startswith("params.c/")]) == 1


def test_btree_with_interior_nodes(tmp_path):
    """A database whose b-tree has interior nodes and several generations
    (small nodes, zstd and uncompressed): every key's value as
    tensorstore wrote it."""
    rs = np.random.RandomState(0)
    for comp in (None, {"id": "zstd", "level": 3}):
        d = str(tmp_path / f"db{comp is None}")
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{d}/",
                              "config": {"compression": comp,
                                         "max_decoded_node_bytes": 300,
                                         "max_inline_value_bytes": 64}}
                             ).result()
        want = {}
        for _ in range(3):
            with ts.Transaction() as txn:
                for i in range(50):
                    k = f"p{rs.randint(9)}.l{rs.randint(30)}/{i}"
                    v = rs.randint(0, 256, rs.randint(0, 300)) \
                        .astype(np.uint8).tobytes()
                    kv.with_transaction(txn).write(k, v).result()
                    want[k] = v
        db = O._Database(d)
        assert {k: bytes(db.value(k)) for k in db.refs} == want


# ---------------------------------------------------------------------------
# port-written snapshots
# ---------------------------------------------------------------------------

def _cfg():
    return TC.tiny_config(hidden_dropout_prob=0.1,
                          attention_probs_dropout_prob=0.1,
                          tag_loss_weight=1.0)


def _snap_equal(a, b):
    assert a["iteration"] == b["iteration"]
    assert int(a["opt"]["step"]) == int(b["opt"]["step"])
    for k in ("mu", "nu"):
        assert a["opt"][k].keys() == b["opt"][k].keys()
        for n in a["opt"][k]:
            assert torch.equal(a["opt"][k][n], b["opt"][k][n]), (k, n)
    assert a["model"].keys() == b["model"].keys()
    for n in a["model"]:
        assert torch.equal(a["model"][n], b["model"][n]), n
    assert torch.equal(a["generator"], b["generator"])
    assert a["generator_device"] == b["generator_device"]


def test_jax_restores_a_port_written_directory(tmp_path):
    """A port snapshot written with backend='orbax' is restored by the JAX
    package's load_state as its own: the msgpack backend's tree (lists
    and all), the same leaves, step an int32 and iteration an int64 0-d
    array, and the generator's state and device code."""
    cfg = _cfg()
    state = _fresh_state(cfg)
    state, _ = TT.make_train_step(cfg, TT.TrainHyper(
        base_lr=1e-3, max_iter=10, warmup_steps=1))(state, _batch(cfg))
    snap = TCk.snapshot(state, 1)
    TCk.save_state(str(tmp_path / "a.orbax"), snap, "orbax")
    TCk.save_state(str(tmp_path / "a.ckpt"), snap, "msgpack")
    got = JCK.load_state(str(tmp_path / "a.orbax"))
    ref = JCK.load_state(str(tmp_path / "a.ckpt"))
    assert np.asarray(got["opt"]["step"]).dtype == np.int32
    assert np.asarray(got["iteration"]).dtype == np.int64
    assert np.asarray(got["iteration"]).shape == ()
    assert int(got["iteration"]) == 1 and int(got["opt"]["step"]) == 1
    assert int(got["generator"]["device"]) == TCk.DEVICE_CODES["cpu"]
    gen = ref.pop("generator")
    np.testing.assert_array_equal(got["generator"].pop("state"),
                                  gen["state"])
    got["generator"].pop("device")
    assert got.pop("generator") == {}
    _same(got, ref)
    assert (jax.tree_util.tree_structure(got["params"])
            == jax.tree_util.tree_structure(ref["params"]))
    # and the port reads both back to the same snapshot
    _snap_equal(TCk.load_state(str(tmp_path / "a.orbax")),
                TCk.load_state(str(tmp_path / "a.ckpt")))


def test_orbax_backend_round_trip(tmp_path):
    """Checkpointer(backend='orbax'): `.orbax` directories, the pointer
    and its fallback over *.ckpt and *.orbax; resume from it is bit-equal
    to resume from the torch backend's file; load_model_state reads the
    weights only."""
    cfg = _cfg()
    state = _fresh_state(cfg)
    ck = TCk.Checkpointer(str(tmp_path / "o"), backend="orbax")
    tk = TCk.Checkpointer(str(tmp_path / "t"))
    p = ck.save(2, state)
    tk.save(2, state)
    assert p.endswith("model_iter_0000002.orbax") and os.path.isdir(p)
    assert ck.last_checkpoint() == p
    tagged = ck.save_tagged("NaN_context_0", 3, state)
    assert tagged.endswith("NaN_context_0.orbax")
    assert ck.last_checkpoint() == p
    _snap_equal(TCk.load_state(p), TCk.load_state(tk.last_checkpoint()))
    weights = TCk.load_model_state(p)
    for n, t in state.model.state_dict().items():
        assert torch.equal(weights[n], t), n
    # the fallback: the pointer names a save that never finished
    shutil.copy(tk.last_checkpoint(),
                str(tmp_path / "o" / "model_iter_0000001.ckpt"))
    with open(ck.pointer_file, "w") as f:
        f.write(str(tmp_path / "o" / "model_iter_0000009.orbax"))
    assert ck.last_checkpoint() == p
    shutil.rmtree(p)
    assert ck.last_checkpoint().endswith("model_iter_0000001.ckpt")


@pytest.mark.parametrize("backend", ["orbax", "msgpack"])
def test_async_save_equals_sync_save(tmp_path, backend):
    """An async save returns before the file is written; a train step run
    between save and wait_until_finished (AdamW updates the parameters
    in place) does not reach it: its contents equal the synchronous save
    made at the same moment."""
    cfg = _cfg()
    step = TT.make_train_step(cfg, TT.TrainHyper(base_lr=1e-2, max_iter=10,
                                                 warmup_steps=1))
    state, _ = step(_fresh_state(cfg), _batch(cfg, 0))
    sync = TCk.Checkpointer(str(tmp_path / "sync"), backend=backend)
    asy = TCk.Checkpointer(str(tmp_path / "async"), backend=backend,
                           async_save=True)
    want = sync.save(1, state)
    got = asy.save(1, state)
    with open(asy.pointer_file) as f:             # the pointer moved
        assert f.read() == got
    before = {n: t.clone() for n, t in state.model.state_dict().items()}
    state, _ = step(state, _batch(cfg, 1))
    assert any(not torch.equal(before[n], t)
               for n, t in state.model.state_dict().items())
    asy.wait_until_finished()
    assert asy.last_blocking_s is not None
    _snap_equal(TCk.load_state(got), TCk.load_state(want))


@pytest.mark.parametrize("backend", ["orbax", "msgpack", "torch"])
def test_async_writer_starts_after_the_next_step(tmp_path, monkeypatch,
                                                 backend):
    """The writer thread is held until a train step has updated the
    parameters and moments in place (through the lists of the JAX tree
    too): the snapshot still holds the state of the save call."""
    import threading
    cfg = _cfg()
    step = TT.make_train_step(cfg, TT.TrainHyper(base_lr=1e-2, max_iter=10,
                                                 warmup_steps=1))
    state, _ = step(_fresh_state(cfg), _batch(cfg, 0))
    want = TCk.Checkpointer(str(tmp_path / "sync"), backend=backend).save(
        1, state)
    go = threading.Event()
    write = TCk.write_tree

    def held(*a, **k):
        assert go.wait(60)
        return write(*a, **k)
    monkeypatch.setattr(TCk, "write_tree", held)
    ck = TCk.Checkpointer(str(tmp_path / "async"), backend=backend,
                          async_save=True)
    got = ck.save(1, state)
    state, _ = step(state, _batch(cfg, 1))
    go.set()
    ck.wait_until_finished()
    _snap_equal(TCk.load_state(got), TCk.load_state(want))


def test_to_host_copies_every_leaf():
    """to_host's copy shares no memory with the tree it copies, through
    dicts, lists and tuples, transposed views included."""
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.rand(3, 4).astype(np.float32))
    tree = {"x": [a.t(), {"y": (a[1], a)}], "n": np.arange(3), "i": 7}
    before = a.clone()
    out, pinned = TCk.to_host(tree)
    assert pinned is None                      # no card tensor
    a.add_(1.0)
    np.testing.assert_array_equal(out["x"][0].numpy(), before.t().numpy())
    np.testing.assert_array_equal(out["x"][1]["y"][1].numpy(),
                                  before.numpy())
    np.testing.assert_array_equal(out["x"][1]["y"][0].numpy(),
                                  before[1].numpy())
    assert out["x"][0].is_contiguous() and out["i"] == 7
    assert isinstance(out["x"][1]["y"], tuple)
    tree["n"][0] = 9
    assert out["n"][0] == 0


def test_async_save_reraises_its_error(tmp_path, monkeypatch):
    ck = TCk.Checkpointer(str(tmp_path), backend="orbax", async_save=True)

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(TCk.orbax_state, "dump", broken)
    ck.save(1, _fresh_state(TC.tiny_config()))
    with pytest.raises(OSError, match="disk full"):
        ck.wait_until_finished()
    ck.wait_until_finished()                       # raised once


# ---------------------------------------------------------------------------
# bad input
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_snapshot(tmp_path):
    rs = np.random.RandomState(0)
    tree = {"params": {"w": rs.standard_normal((300, 200))
                       .astype(np.float32),
                       "b": jnp.asarray(rs.standard_normal(7),
                                        jnp.bfloat16)}}
    return _jax_save(tmp_path / "run", tree)


def _node_files(path):
    out = []
    for d, _, files in os.walk(path):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                if fh.read(4) == bytes.fromhex("0cdb20de"):
                    out.append(p)
    return out


def test_flipped_byte_in_a_node_raises(jax_snapshot):
    """The root database's b-tree node with one byte flipped fails its
    CRC-32C; ValueError names the file."""
    node = [p for p in _node_files(jax_snapshot)
            if os.sep + "ocdbt.process_" not in p][0]
    with open(node, "r+b") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes((b[0] ^ 0x40,)))
    with pytest.raises(ValueError, match="CRC-32C") as e:
        O.load(jax_snapshot)
    assert os.path.basename(node) in str(e.value)


def test_truncated_data_file_raises(jax_snapshot):
    """The data file holding the chunks, cut short: ValueError names it
    and the byte offset."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(jax_snapshot)
             for f in fs if os.sep + "d" + os.sep in os.path.join(d, f)]
    big = max(files, key=os.path.getsize)
    with open(big, "r+b") as f:
        f.truncate(os.path.getsize(big) // 2)
    with pytest.raises(ValueError, match="truncated|CRC") as e:
        O.load(jax_snapshot)
    assert os.path.basename(big) in str(e.value)


def test_deleted_chunk_raises(jax_snapshot):
    """A chunk deleted from the database (a newer generation without it)
    with a null fill_value: ValueError naming the snapshot and key."""
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{jax_snapshot}/"}).result()
    kv.delete_range(ts.KvStore.KeyRange("params.w/0.0",
                                        "params.w/0.0\x00")).result()
    with pytest.raises(ValueError, match="params.w/0.0") as e:
        O.load(jax_snapshot)
    assert os.path.basename(jax_snapshot) in str(e.value)


def test_zarr3_and_unknown_leaves_raise(jax_snapshot):
    md_path = os.path.join(jax_snapshot, "_METADATA")
    with open(md_path) as f:
        md = json.load(f)
    with open(md_path, "w") as f:
        json.dump(dict(md, use_zarr3=True), f)
    with pytest.raises(ValueError, match="_METADATA.*use_zarr3"):
        O.load(jax_snapshot)
    entry = next(iter(md["tree_metadata"].values()))
    entry["value_metadata"]["value_type"] = "string"
    with open(md_path, "w") as f:
        json.dump(md, f)
    with pytest.raises(ValueError, match="value_type 'string'"):
        O.load(jax_snapshot)


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def test_fixture_decodes_bit_equal_to_its_msgpack_twin():
    """The JAX-written directory decodes to its msgpack twin's leaves,
    bit for bit (same tree, dtypes, shapes), and to the JAX package's
    load_state; its frames hold raw, RLE and compressed blocks, Huffman
    literals and FSE-compressed sequence tables."""
    got = O.load(FIXTURE)
    _same(got, msgpack_state.load(FIXTURE + ".ckpt"))
    _same(got, JCK.load_state(FIXTURE))
    counts = np.zeros(len(O.COUNTERS), np.uint64)
    for key, src, n in O.chunk_frames(FIXTURE):
        O.zstd_decode_into(src, np.empty(n, np.uint8), key, counts)
    c = dict(zip(O.COUNTERS, counts.tolist()))
    for kind in ("raw_blocks", "rle_blocks", "compressed_blocks",
                 "literals_huffman", "huffman_fse_weights",
                 "sequences_fse"):
        assert c[kind] > 0, (kind, c)
    assert os.path.getsize(FIXTURE + ".ckpt") + sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(FIXTURE)
        for f in fs) < 4 << 20


def test_fixture_regenerates_to_the_same_values(tmp_path):
    """tests/make_orbax_fixture.py run again (2 JAX train steps) writes a
    directory that decodes to the committed one's values, and the same
    msgpack twin."""
    import make_orbax_fixture
    make_orbax_fixture.build(str(tmp_path))
    _same(O.load(str(tmp_path / "orbax_jax_tiny")), O.load(FIXTURE))
    _same(msgpack_state.load(str(tmp_path / "orbax_jax_tiny.ckpt")),
          msgpack_state.load(FIXTURE + ".ckpt"))


def test_fixture_params_load_through_the_bridge():
    """The fixture's weights reach the port's names through
    load_model_state, as the JAX bridge names them."""
    weights = TCk.load_model_state(FIXTURE)
    params = JCK.load_state(FIXTURE)["params"]
    want = {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in JB.params_to_torch_state_dict(
                jax.tree_util.tree_map(np.asarray, params)).items()}
    assert weights.keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_array_equal(weights[n].numpy(), w, err_msg=n)
