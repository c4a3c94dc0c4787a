"""The JAX package's orbax snapshot format (orbax.checkpoint's
StandardCheckpointHandler with OCDBT and zarr v2, as
vitcap_tpu/solver/checkpointing.py writes it), read and written without
orbax, tensorstore or zstandard.

A snapshot is a directory:
- `_METADATA`: JSON; `tree_metadata` maps each leaf's key path, e.g.
  "('params', 'enc', 'kernel')", to its keys (`key_type` 2 a map key, 1 a
  list index) and its `value_type`; `use_ocdbt` true, `use_zarr3` false.
- `_CHECKPOINT_METADATA`, `_sharding`, `array_metadatas/process_<n>`:
  orbax's bookkeeping (not needed to read the arrays).
- `manifest.ocdbt` and `d/<hex>`: an OCDBT key-value database; with more
  than one writer its b-tree refers to data files under every
  `ocdbt.process_<n>/d/` too.
- In that database each leaf is a zarr v2 array named by its key path
  joined with '.': `<name>/.zarray` (JSON: shape, chunks, dtype,
  compressor, fill_value) and one value per chunk, `<name>/0.0` and so on
  (`<name>/0` for a 0-d array); every chunk is one zstd frame.

OCDBT (tensorstore's "OCDBT storage format"): a manifest or b-tree node
is `0cdb3a2a` (manifest) or `0cdb20de` (node), the whole length (u64 LE),
a version varint (0) and a compression varint (0 none, 1 zstd), then the
body, then the CRC-32C of all that came before (u32 LE).  The manifest's
body holds the database's configuration, a table of data files and the
versions (each a generation's b-tree root: file, offset, length); the
newest is read.  A node's body holds its height, a table of data files,
its keys (prefix-compressed: each key shares a prefix with the one before
it, and a node's keys omit the prefix its parent's entry gives them) and,
in a leaf, each value inline or as a (file, offset, length) reference, in
an interior node each child's (file, offset, length) and statistics.
Lists are stored column by column, integers as LEB128 varints.

load walks the newest version's b-tree, keeps the references, and
decompresses only the chunks of the leaves asked for, with the port's
hand-written zstd decoder (native/zstd.cpp), in parallel over a thread
pool, straight into each tensor's memory when the array is one chunk.
Every node and manifest is checked against its CRC-32C.  Anything it does
not know raises ValueError naming the file and the byte offset: a zarr3
or non-OCDBT snapshot, a bad CRC, a truncated file, a missing chunk
without a fill value, an unknown dtype, codec or node kind.

dump writes a directory that the JAX package's load_state restores as
its own (every leaf a numpy array of the same key path, dtype and
shape): the chunks are zstd frames of raw blocks (valid zstd, so
`.zarray` names the zstd compressor as orbax writes it, and no encoder is
needed), the b-tree one uncompressed leaf after them in one data file.
It writes into a temporary directory beside the target, then moves it
into place with os.replace.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import mmap
import os
import os.path as op
import shutil
import struct
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = 2 ** 64 - 1            # the offset of an empty tree's root
MANIFEST_LIMIT = 64 << 20        # decoded manifest bytes read at most
RAW_BLOCK = 128 * 1024           # zstd's largest block
KEY_SEQUENCE, KEY_DICT = 1, 2    # orbax's key_type
ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
EMPTY = {"Dict": dict, "List": list, "None": lambda: None}  # no data

DTYPES = {
    "<f4": torch.float32, "<f2": torch.float16, "<f8": torch.float64,
    "bfloat16": torch.bfloat16, "<i4": torch.int32, "<i8": torch.int64,
    "<i2": torch.int16, "|i1": torch.int8, "|u1": torch.uint8,
    "|b1": torch.bool, "<u4": torch.uint32,
}
NAMES = {v: k for k, v in DTYPES.items()}

# vc_zstd_decode's counters, in native/zstd.cpp's order
COUNTERS = ("frames", "skippable_frames", "checksums", "raw_blocks",
            "rle_blocks", "compressed_blocks", "literals_raw",
            "literals_rle", "literals_huffman", "literals_treeless",
            "literals_4_streams", "huffman_fse_weights",
            "huffman_direct_weights", "sequences_predefined",
            "sequences_rle", "sequences_fse", "sequences_repeat",
            "sequences")


# ---------------------------------------------------------------------------
# the native decoder
# ---------------------------------------------------------------------------

def _lib():
    from ..native import library
    lib = library("zstd")
    if lib.vc_zstd_counter_count() != len(COUNTERS):
        raise RuntimeError("vitcap_tpu_torch/native/zstd.cpp's counters "
                           "and COUNTERS differ")
    return lib


def _address(buf) -> int:
    """The address of a buffer's first byte (bytes, a numpy array, a
    tensor on the CPU)."""
    if isinstance(buf, torch.Tensor):
        return buf.data_ptr()
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value


def _zstd(src, dst, cap: int, where: str, counts=None) -> int:
    """Decode the zstd frames of `src` (bytes or a uint8 numpy array) into
    `cap` bytes at `dst`'s address; -> the bytes written.  ValueError
    names `where` and the byte offset of what is malformed."""
    n = src.nbytes if isinstance(src, np.ndarray) else len(src)
    written, err = ctypes.c_size_t(), ctypes.c_size_t()
    msg = ctypes.create_string_buffer(256)
    if counts is not None and (counts.dtype != np.uint64
                               or counts.size != len(COUNTERS)):
        raise ValueError(f"counts: a uint64 array of {len(COUNTERS)}")
    rc = _lib().vc_zstd_decode(
        _address(src) if n else None, n, _address(dst) if cap else None, cap,
        ctypes.byref(written), ctypes.byref(err),
        None if counts is None else counts.ctypes.data, msg, len(msg))
    if rc != 0:
        raise ValueError(f"orbax: {where}: zstd: {msg.value.decode()} at "
                         f"byte {err.value} of the frame")
    return written.value


def zstd_decode_into(src, dst, where: str,
                     counts: Optional[np.ndarray] = None) -> None:
    """Decode the zstd frames of `src` (bytes or a uint8 numpy array) into
    `dst` (a contiguous CPU tensor or a numpy array), which they must fill
    exactly; ValueError names `where` and the byte offset otherwise.
    `counts`: a uint64 array of len(COUNTERS) that gains the counters."""
    cap = dst.numel() * dst.element_size() if isinstance(dst, torch.Tensor) \
        else dst.nbytes
    written = _zstd(src, dst, cap, where, counts)
    if written != cap:
        raise ValueError(f"orbax: {where}: zstd frame decodes to "
                         f"{written} bytes, {cap} expected")


def zstd_decode(src: bytes, limit: int, where: str) -> bytes:
    """The bytes of the zstd frames of `src`, at most `limit` of them (the
    buffer is only reserved: the pages it does not use are never
    touched)."""
    out = np.empty(limit, np.uint8)
    return out[:_zstd(src, out, limit, where)].tobytes()


def crc32c(data: bytes) -> int:
    return _lib().vc_crc32c(_address(data), len(data), 0) if data else 0


def zstd_raw_header(nbytes: int) -> bytes:
    """A zstd frame header for `nbytes` of content in raw blocks: no
    single segment, a 128 KiB window, an 8-byte content size."""
    return (struct.pack("<I", 0xFD2FB528) + bytes((0xC0, 7 << 3))
            + struct.pack("<Q", nbytes))


def zstd_raw_blocks(nbytes: int) -> List[Tuple[int, int, bytes]]:
    """(start, stop, header) of each raw block of `nbytes` of content (one
    empty last block for none)."""
    out = []
    for s in range(0, max(nbytes, 1), RAW_BLOCK):
        e = min(nbytes, s + RAW_BLOCK)
        last = 1 if e == nbytes else 0
        out.append((s, e, ((e - s) << 3 | last).to_bytes(3, "little")))
    return out


# ---------------------------------------------------------------------------
# OCDBT: byte decoding
# ---------------------------------------------------------------------------

class _Cursor:
    """Reads a decoded body; errors name the file and the offset of the
    sealed region the body came from."""

    def __init__(self, data: bytes, where: str):
        self.d, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        raise ValueError(f"orbax: {self.where}: {what} at byte {self.pos} "
                         f"of the decoded body")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.d):
            self.fail(f"truncated ({n} bytes wanted)")
        b = self.d[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.pos >= len(self.d):
                self.fail("truncated varint")
            b = self.d[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 10 bytes")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def data_files(self) -> List[str]:
        """A data file table: each path (relative to the database's
        directory) as base path + relative path, prefix-compressed."""
        n = self.varint()
        prefix = self.varints(max(n - 1, 0))
        suffix = self.varints(n)
        base = self.varints(n)
        out, prev = [], b""
        for i in range(n):
            p = 0 if i == 0 else prefix[i - 1]
            if p > len(prev):
                self.fail("a data file's prefix longer than the path before")
            full = prev[:p] + self.take(suffix[i])
            if base[i] > len(full):
                self.fail("a data file's base path longer than its path")
            prev = full
            path = full.decode("utf-8", "replace")
            if op.isabs(path) or op.normpath(path).startswith(".."):
                self.fail(f"data file {path!r} outside the database")
            out.append(path)
        return out

    def keys(self, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
        prefix = self.varints(max(n - 1, 0))
        suffix = self.varints(n)
        sub = self.varints(n) if interior else []
        keys, prev = [], b""
        for i in range(n):
            p = 0 if i == 0 else prefix[i - 1]
            if p > len(prev):
                self.fail("a key's shared prefix longer than the key before")
            prev = prev[:p] + self.take(suffix[i])
            keys.append(prev)
        for i, s in enumerate(sub):
            if s > len(keys[i]):
                self.fail("a subtree prefix longer than its key")
        return keys, sub


class _Ref:
    """A value: inline bytes, or `length` bytes at `offset` of `file`."""
    __slots__ = ("inline", "file", "offset", "length")

    def __init__(self, inline=None, file=None, offset=0, length=0):
        self.inline, self.file = inline, file
        self.offset, self.length = offset, length


class _Database:
    """An OCDBT database directory: its newest version's keys, each with
    its value's reference."""

    def __init__(self, root: str):
        self.root = root
        self.maps: Dict[str, np.ndarray] = {}
        manifest = op.join(root, "manifest.ocdbt")
        if not op.isfile(manifest):
            raise ValueError(f"orbax: {manifest}: missing (not an OCDBT "
                             f"snapshot)")
        size = os.path.getsize(manifest)
        c = self._sealed("manifest.ocdbt", 0, size, MANIFEST_MAGIC,
                         MANIFEST_LIMIT)
        c.take(16)                                    # uuid
        kind = c.varint()
        if kind != 0:
            c.fail(f"manifest kind {kind} (only a single-file manifest "
                   f"is read)")
        c.varint()                                    # max inline bytes
        self.node_limit = c.varint()                  # max decoded node
        c.u8()                                        # version tree arity
        comp = c.varint()
        if comp == 1:
            c.take(4)                                 # zstd level
        elif comp != 0:
            c.fail(f"compression method {comp}")
        files = c.data_files()
        n = c.varint()
        if n == 0:
            c.fail("no version")
        gen = c.varints(n)
        height = [c.u8() for _ in range(n)]
        fid = c.varints(n)
        off = c.varints(n)
        length = c.varints(n)
        # the rest (statistics, commit times, older version tree nodes)
        # is not needed to read the newest version
        i = max(range(n), key=lambda j: gen[j])
        self.refs: Dict[str, _Ref] = {}
        if off[i] != MISSING:
            if fid[i] >= len(files):
                c.fail(f"data file {fid[i]} of {len(files)}")
            self._walk(files[fid[i]], off[i], length[i], b"", height[i])

    # -- files --------------------------------------------------------------

    def data(self, rel: str) -> np.ndarray:
        """The bytes of a data file (mapped read-only, once)."""
        arr = self.maps.get(rel)
        if arr is None:
            path = op.join(self.root, rel)
            if not op.isfile(path):
                raise ValueError(f"orbax: {path}: missing data file")
            with open(path, "rb") as f:
                if os.fstat(f.fileno()).st_size == 0:
                    arr = np.empty(0, np.uint8)
                else:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                    arr = np.frombuffer(mm, np.uint8)
            self.maps[rel] = arr
        return arr

    def region(self, rel: str, offset: int, length: int) -> np.ndarray:
        arr = self.data(rel)
        if offset + length > arr.size:
            raise ValueError(f"orbax: {op.join(self.root, rel)}: truncated: "
                             f"{length} bytes wanted at byte {offset}, the "
                             f"file has {arr.size}")
        return arr[offset:offset + length]

    def _sealed(self, rel: str, offset: int, length: int, magic: int,
                limit: int) -> _Cursor:
        """A manifest or node at `offset` of `rel`: header, CRC-32C and
        body checked, the body decompressed."""
        where = f"{op.join(self.root, rel)} at byte {offset}"
        raw = self.region(rel, offset, length).tobytes()
        if len(raw) < 18:
            raise ValueError(f"orbax: {where}: {len(raw)} bytes, too short "
                             f"for a sealed OCDBT record")
        got = struct.unpack(">I", raw[:4])[0]
        if got != magic:
            raise ValueError(f"orbax: {where}: magic {got:08x}, "
                             f"{magic:08x} expected")
        if struct.unpack("<Q", raw[4:12])[0] != length:
            raise ValueError(f"orbax: {where}: length field "
                             f"{struct.unpack('<Q', raw[4:12])[0]}, the "
                             f"reference says {length}")
        crc = struct.unpack("<I", raw[-4:])[0]
        if crc32c(raw[:-4]) != crc:
            raise ValueError(f"orbax: {where}: CRC-32C mismatch (stored "
                             f"{crc:08x}, computed {crc32c(raw[:-4]):08x})")
        c = _Cursor(raw[:-4], where)
        c.pos = 12
        version, comp = c.varint(), c.varint()
        if version != 0:
            c.fail(f"format version {version}")
        body = raw[c.pos:-4]
        if comp == 1:
            body = zstd_decode(body, limit, where)
        elif comp != 0:
            c.fail(f"compression format {comp}")
        return _Cursor(body, where)

    # -- the b-tree -----------------------------------------------------------

    def _walk(self, rel: str, offset: int, length: int, prefix: bytes,
              height: int) -> None:
        c = self._sealed(rel, offset, length, NODE_MAGIC, self.node_limit)
        h = c.u8()
        if h != height:
            c.fail(f"node height {h}, its parent says {height}")
        files = c.data_files()
        n = c.varint()
        keys, sub = c.keys(n, interior=h > 0)

        def file_of(i):
            if i >= len(files):
                c.fail(f"data file {i} of {len(files)}")
            return files[i]

        if h > 0:
            fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
            for i in range(n):
                self._walk(file_of(fid[i]), off[i], ln[i],
                           prefix + keys[i][:sub[i]], h - 1)
            return
        lengths = c.varints(n)
        kinds = [c.u8() for _ in range(n)]
        if any(k > 1 for k in kinds):
            c.fail(f"value kind {max(kinds)} (0 inline, 1 indirect known)")
        ind = [i for i in range(n) if kinds[i] == 1]
        fid, off = c.varints(len(ind)), c.varints(len(ind))
        for j, i in enumerate(ind):
            self.refs[(prefix + keys[i]).decode("utf-8", "replace")] = _Ref(
                file=file_of(fid[j]), offset=off[j], length=lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self.refs[(prefix + keys[i]).decode("utf-8", "replace")] = \
                    _Ref(inline=c.take(lengths[i]))
        if c.pos != len(c.d):
            c.fail(f"{len(c.d) - c.pos} bytes after the leaf's values")

    def value(self, key: str):
        """A key's value (bytes or a uint8 array over the mapping)."""
        ref = self.refs[key]
        if ref.inline is not None:
            return ref.inline
        return self.region(ref.file, ref.offset, ref.length)

    def where(self, key: str) -> str:
        ref = self.refs[key]
        if ref.inline is not None:
            return f"{self.root} key {key!r} (inline)"
        return (f"{op.join(self.root, ref.file)} at byte {ref.offset} "
                f"(key {key!r})")


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _read_json(path: str) -> Any:
    if not op.isfile(path):
        raise ValueError(f"orbax: {path}: missing")
    with open(path, "rb") as f:
        data = f.read()
    try:
        return json.loads(data)
    except ValueError as e:
        raise ValueError(f"orbax: {path}: not JSON ({e})") from None


def _leaves(path: str) -> List[Tuple[Tuple[Tuple[Any, int], ...], str]]:
    """(((key, key_type), ...), value_type) of each leaf in _METADATA."""
    md_path = op.join(path, "_METADATA")
    md = _read_json(md_path)
    if not isinstance(md, dict) or "tree_metadata" not in md:
        raise ValueError(f"orbax: {md_path}: no tree_metadata")
    if md.get("use_zarr3"):
        raise ValueError(f"orbax: {md_path}: use_zarr3 is true (zarr v3 "
                         f"arrays are not read; orbax wrote zarr v2 here "
                         f"before)")
    if not md.get("use_ocdbt"):
        raise ValueError(f"orbax: {md_path}: use_ocdbt is not true (only "
                         f"OCDBT snapshots are read)")
    out = []
    for name, entry in md["tree_metadata"].items():
        try:
            keys = tuple((k["key"], int(k["key_type"]))
                         for k in entry["key_metadata"])
            vtype = entry["value_metadata"]["value_type"]
        except (KeyError, TypeError):
            raise ValueError(f"orbax: {md_path}: entry {name} lacks "
                             f"key_metadata or value_type") from None
        if any(t not in (KEY_SEQUENCE, KEY_DICT) for _, t in keys):
            raise ValueError(f"orbax: {md_path}: entry {name}: key type "
                             f"other than 1 (list) or 2 (map)")
        out.append((keys, vtype))
    return out


def _nest(items: List[Tuple[Tuple[Tuple[Any, int], ...], Any]],
          where: str) -> Any:
    """The tree of (path, value) pairs; a level whose keys are list
    indices becomes a list (its indices must be 0..n-1)."""
    root: Dict[Any, Any] = {}
    kinds: Dict[int, int] = {}
    for keys, v in items:
        node = root
        for depth, (k, t) in enumerate(keys):
            kinds[id(node)] = t
            if depth == len(keys) - 1:
                node[str(k)] = v
            else:
                node = node.setdefault(str(k), {})

    def fix(node):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v) for k, v in node.items()}
        if kinds.get(id(node)) == KEY_SEQUENCE:
            try:
                idx = sorted(int(k) for k in out)
            except ValueError:
                raise ValueError(f"orbax: {where}: a list index that is "
                                 f"no integer") from None
            if idx != list(range(len(idx))):
                raise ValueError(f"orbax: {where}: list indices {idx} are "
                                 f"not 0..n-1")
            return [out[str(i)] for i in range(len(idx))]
        return out
    return fix(root)


class _Array:
    """One zarr v2 array of the database: its .zarray checked."""

    def __init__(self, db: _Database, name: str):
        self.name = name
        key = f"{name}/.zarray"
        if key not in db.refs:
            raise ValueError(f"orbax: {db.root}: no {key}")
        where = db.where(key)
        raw = db.value(key)
        raw = raw if isinstance(raw, bytes) else raw.tobytes()
        try:
            z = json.loads(raw)
        except ValueError:
            raise ValueError(f"orbax: {where}: .zarray is not JSON") from None
        if z.get("zarr_format") != 2:
            raise ValueError(f"orbax: {where}: zarr_format "
                             f"{z.get('zarr_format')!r}, 2 expected")
        dt = DTYPES.get(z.get("dtype"))
        if dt is None:
            raise ValueError(f"orbax: {where}: dtype {z.get('dtype')!r} "
                             f"(known: {sorted(DTYPES)})")
        if z.get("order", "C") != "C":
            raise ValueError(f"orbax: {where}: order {z.get('order')!r}")
        if z.get("filters"):
            raise ValueError(f"orbax: {where}: filters {z['filters']!r}")
        comp = z.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise ValueError(f"orbax: {where}: compressor {comp!r} (zstd "
                             f"or none known)")
        self.zstd = comp is not None
        self.dtype, self.where = dt, where
        self.shape = [int(d) for d in z["shape"]]
        self.chunks = [int(d) for d in z["chunks"]]
        if len(self.chunks) != len(self.shape) or any(
                c <= 0 for c in self.chunks):
            raise ValueError(f"orbax: {where}: chunks {self.chunks} for "
                             f"shape {self.shape}")
        self.sep = z.get("dimension_separator", ".")
        self.fill = z.get("fill_value")

    def chunk_keys(self):
        """(chunk index, key) of every chunk of the grid."""
        grid = [-(-s // c) for s, c in zip(self.shape, self.chunks)]
        if not self.shape:
            yield (), f"{self.name}/0"
            return
        for idx in itertools.product(*(range(g) for g in grid)):
            yield idx, f"{self.name}/" + self.sep.join(map(str, idx))


def _fill(t: torch.Tensor, value, where: str) -> None:
    if isinstance(value, str):       # zarr v2 writes NaN/Infinity as text
        value = {"NaN": float("nan"), "Infinity": float("inf"),
                 "-Infinity": float("-inf")}.get(value)
        if value is None:
            raise ValueError(f"orbax: {where}: fill_value not a number")
    t.fill_(value)


def _plan(db: _Database, arr: _Array, out: torch.Tensor, tasks: list,
          copies: list) -> None:
    """Queue the decode of each chunk of `arr` into `out`: straight into
    its memory when the array is one chunk, else into a full chunk-sized
    buffer (zarr v2's edge chunks are full size) whose valid part is then
    copied into place."""
    whole = arr.chunks == arr.shape
    for idx, key in arr.chunk_keys():
        if key not in db.refs:
            if arr.fill is None:
                raise ValueError(f"orbax: {db.root}: chunk {key!r} missing "
                                 f"and fill_value is null")
            dst = out if whole else out[tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, arr.chunks, arr.shape))]
            _fill(dst, arr.fill, arr.where)
            continue
        if whole:
            tasks.append((db, key, out, arr.zstd))
            continue
        buf = torch.empty(arr.chunks, dtype=arr.dtype)
        tasks.append((db, key, buf, arr.zstd))
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, arr.chunks, arr.shape))
        copies.append((out, sl, buf))


def _decode(task, counts=None) -> None:
    db, key, dst, zstd = task
    src = db.value(key)
    if isinstance(src, bytes):
        src = np.frombuffer(src, np.uint8)
    if dst.numel() == 0 and src.size == 0:
        return
    if zstd:
        zstd_decode_into(src, dst, db.where(key), counts)
        return
    nbytes = dst.numel() * dst.element_size()
    if src.size != nbytes:
        raise ValueError(f"orbax: {db.where(key)}: {src.size} bytes for an "
                         f"uncompressed chunk of {nbytes}")
    dst.view(-1).view(torch.uint8).numpy()[:] = src


def load(path: str, only: Optional[Iterable[str]] = None) -> Any:
    """The tree of an orbax snapshot directory: nested dicts (lists where
    orbax recorded list indices) of CPU tensors, each owning its memory,
    decoded on a pool of one thread a CPU.  `only`: the top-level keys to
    read (e.g. ('params',)); the other leaves' chunks are never
    decompressed."""
    path = op.abspath(path)
    leaves = _leaves(path)
    if only is not None:
        only = set(only)
        leaves = [lf for lf in leaves if str(lf[0][0][0]) in only]
    db = _Database(path)
    tasks: list = []
    copies: list = []
    items = []
    empty = []
    for keys, vtype in leaves:
        if vtype in EMPTY:
            empty.append((keys, EMPTY[vtype]()))
            continue
        if vtype not in ARRAY_TYPES:
            raise ValueError(f"orbax: {path}: leaf {keys} has value_type "
                             f"{vtype!r} (known: {ARRAY_TYPES} and the "
                             f"empty {tuple(EMPTY)})")
        arr = _Array(db, ".".join(str(k) for k, _ in keys))
        out = torch.empty(arr.shape, dtype=arr.dtype)
        _plan(db, arr, out, tasks, copies)
        items.append((keys, (out, vtype)))
    tasks.sort(key=lambda t: -t[2].numel() * t[2].element_size())
    n = os.cpu_count() or 1
    if n > 1 and len(tasks) > 1:
        with ThreadPoolExecutor(min(n, len(tasks))) as pool:
            list(pool.map(_decode, tasks))
    else:
        for t in tasks:
            _decode(t)
    for out, sl, buf in copies:
        out[sl] = buf[tuple(slice(0, s.stop - s.start) for s in sl)]
    tree = [(keys, out.item() if vtype == "scalar" else out)
            for keys, (out, vtype) in items]
    return _nest(tree + empty, op.join(path, "_METADATA"))


def chunk_frames(path: str) -> List[Tuple[str, np.ndarray, int]]:
    """(key, compressed bytes, decoded size) of every zstd chunk of a
    snapshot: what load decompresses, for tests and timing."""
    path = op.abspath(path)
    db = _Database(path)
    out = []
    for keys, vtype in _leaves(path):
        if vtype in EMPTY:
            continue
        arr = _Array(db, ".".join(str(k) for k, _ in keys))
        if not arr.zstd:
            continue
        nbytes = int(np.prod(arr.chunks, dtype=np.int64)) \
            * arr.dtype.itemsize
        for _, key in arr.chunk_keys():
            if key in db.refs:
                src = db.value(key)
                if isinstance(src, bytes):
                    src = np.frombuffer(src, np.uint8)
                out.append((key, src, nbytes))
    return out


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _flatten(tree, keys=()) -> List[Tuple[Tuple[Tuple[str, int], ...], Any]]:
    """((key, key_type), ...) paths and leaves, map keys sorted (as orbax's
    metadata lists them)."""
    if isinstance(tree, dict) and tree:
        out = []
        for k in sorted(tree, key=str):
            out += _flatten(tree[k], keys + ((str(k), KEY_DICT),))
        return out
    if isinstance(tree, (list, tuple)) and tree:
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, keys + ((str(i), KEY_SEQUENCE),))
        return out
    return [(keys, tree)]


def _as_tensor(x, where: str) -> torch.Tensor:
    if isinstance(x, np.generic):
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        if x.dtype.byteorder == ">":
            raise ValueError(f"orbax: {where}: big-endian {x.dtype}")
        x = torch.from_numpy(x if x.flags.c_contiguous else x.copy())
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"orbax: {where}: cannot write a "
                         f"{type(x).__name__} (arrays only)")
    if x.dtype not in NAMES:
        raise ValueError(f"orbax: {where}: dtype {x.dtype} is not written "
                         f"(known: {sorted(map(str, NAMES))})")
    return x.detach().contiguous().to("cpu")   # a transpose on its device


def _varints(vals: Iterable[int]) -> bytes:
    out = bytearray()
    for v in vals:
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


def _data_files(paths: List[str]) -> bytes:
    """A data file table with no prefix sharing and empty base paths."""
    enc = [p.encode() for p in paths]
    return (_varints([len(enc)]) + _varints([0] * max(len(enc) - 1, 0))
            + _varints(len(p) for p in enc) + _varints([0] * len(enc))
            + b"".join(enc))


def _seal(magic: int, body: bytes) -> bytes:
    """Header (uncompressed), body, CRC-32C."""
    head_len = 4 + 8 + 2
    total = head_len + len(body) + 4
    raw = struct.pack(">I", magic) + struct.pack("<Q", total) + b"\x00\x00" \
        + body
    return raw + struct.pack("<I", crc32c(raw))


def _leaf_node(entries: List[Tuple[bytes, Any]], data_file: str) -> bytes:
    """A leaf node's body (height 0) of keys sorted by bytes; a value is
    inline bytes or an (offset, length) reference into `data_file`."""
    n = len(entries)
    keys = [k for k, _ in entries]
    shared = []
    for a, b in zip(keys, keys[1:]):
        m = 0
        while m < min(len(a), len(b)) and a[m] == b[m]:
            m += 1
        shared.append(m)
    suffixes = [keys[0]] + [b[m:] for b, m in zip(keys[1:], shared)]
    inline = [v for _, v in entries if isinstance(v, bytes)]
    refs = [v for _, v in entries if not isinstance(v, bytes)]
    body = (bytes((0,)) + _data_files([data_file])
            + _varints([n]) + _varints(shared)
            + _varints(len(s) for s in suffixes) + b"".join(suffixes)
            + _varints(len(v) if isinstance(v, bytes) else v[1]
                       for _, v in entries)
            + bytes(0 if isinstance(v, bytes) else 1 for _, v in entries)
            + _varints([0] * len(refs)) + _varints(r[0] for r in refs)
            + b"".join(inline))
    return body


def _write_all(fd: int, bufs: list) -> None:
    """os.writev in batches, resuming after short writes."""
    views = [memoryview(b).cast("B") for b in bufs if len(b)]
    i = 0
    while i < len(views):
        batch = views[i:i + 512]
        n = os.writev(fd, batch)
        for v in batch:
            if n >= len(v):
                n -= len(v)
                i += 1
            else:
                views[i] = v[n:]
                break


def dump(path: str, tree: Any) -> None:
    """Write `tree` (nested dicts and lists of tensors or numpy arrays) as
    an orbax snapshot directory at `path`, atomically: built in a
    temporary directory beside it, which then replaces it."""
    path = op.abspath(path)
    parent = op.dirname(path)
    os.makedirs(parent, exist_ok=True)
    leaves = _flatten(tree)
    if not leaves:
        raise ValueError("orbax: an empty tree")
    stamp = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{stamp}"
    data_name = "d/" + uuid.uuid4().hex
    os.makedirs(op.join(tmp, "d"))
    os.makedirs(op.join(tmp, "array_metadatas"))
    try:
        entries: List[Tuple[bytes, Any]] = []
        tree_md = {}
        indirect = 0
        fd = os.open(op.join(tmp, data_name),
                     os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        try:
            pos = 0
            for keys, leaf in leaves:
                name = ".".join(k for k, _ in keys)
                empty = {dict: "Dict", list: "List", tuple: "List",
                         type(None): "None"}.get(type(leaf))
                tree_md[str(tuple(k for k, _ in keys))] = {
                    "key_metadata": [{"key": k, "key_type": kt}
                                     for k, kt in keys],
                    "value_metadata": {
                        "value_type": empty or "np.ndarray",
                        "skip_deserialize": empty is not None}}
                if empty is not None:
                    continue
                t = _as_tensor(leaf, name)
                zarray = json.dumps(
                    {"chunks": list(t.shape),
                     "compressor": {"id": "zstd", "level": 1},
                     "dimension_separator": ".", "dtype": NAMES[t.dtype],
                     "fill_value": None, "filters": None, "order": "C",
                     "shape": list(t.shape), "zarr_format": 2},
                    sort_keys=True, separators=(",", ":")).encode()
                entries.append((f"{name}/.zarray".encode(), zarray))
                raw = t.reshape(-1).view(torch.uint8).numpy() \
                    if t.numel() else np.empty(0, np.uint8)
                nbytes = raw.nbytes
                bufs = [zstd_raw_header(nbytes)]
                for s, e, head in zstd_raw_blocks(nbytes):
                    bufs += [head, raw[s:e]]
                _write_all(fd, bufs)
                size = sum(len(memoryview(b).cast("B")) for b in bufs)
                chunk = "0" if t.dim() == 0 else ".".join(["0"] * t.dim())
                entries.append((f"{name}/{chunk}".encode(), (pos, size)))
                pos += size
                indirect += size
            entries.sort(key=lambda kv: kv[0])
            node = _seal(NODE_MAGIC, _leaf_node(entries, data_name))
            _write_all(fd, [node])
        finally:
            os.close(fd)
        manifest = (uuid.uuid4().bytes + _varints([0, 1024, 100_000_000])
                    + bytes((4,)) + _varints([0])
                    + _data_files([data_name])
                    + _varints([1, 1]) + bytes((0,))
                    + _varints([0, pos, len(node), len(entries), len(node),
                                indirect])
                    + struct.pack("<Q", stamp) + _varints([0]))
        with open(op.join(tmp, "manifest.ocdbt"), "wb") as f:
            f.write(_seal(MANIFEST_MAGIC, manifest))
        with open(op.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree_md, "use_ocdbt": True,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(op.join(tmp, "array_metadatas", "process_0"), "w") as f:
            json.dump({"array_metadatas": []}, f)
        with open(op.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                       "standard_checkpoint_handler."
                       "StandardCheckpointHandler",
                       "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": stamp,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        old = None
        if op.lexists(path):
            old = f"{path}.orbax-checkpoint-old-{stamp}"
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            if op.isdir(old) and not op.islink(old):
                shutil.rmtree(old)
            else:
                os.remove(old)
    finally:
        if op.exists(tmp):
            shutil.rmtree(tmp)
