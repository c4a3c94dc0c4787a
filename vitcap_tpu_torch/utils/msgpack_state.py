"""The JAX package's snapshot format, flax's msgpack serialization
(flax/serialization.py msgpack_serialize / msgpack_restore), read and
written without the msgpack module.

The layout:
- nested maps with string keys, and lists (arrays), which stay lists;
- ext 1, an ndarray: the msgpack triple (shape, dtype name, C-order
  bytes);
- ext 2, a Python complex: the pair (real, imag), read only;
- ext 3, a numpy scalar: an ndarray triple of shape ();
- past MAX_CHUNK_SIZE bytes, a leaf that is a map's value (or the top
  object) is written as {'__msgpack_chunked_array__': True, 'shape':
  {'0': d0, ...}, 'chunks': {'0': flat part, ...}}, parts of
  MAX_CHUNK_SIZE // itemsize elements, as flax writes it.

load maps the file (a private copy-on-write mapping) and builds each
array with torch.frombuffer over it, so the file's bytes are copied into
no Python object; a tensor keeps the mapping alive.  dump streams each
leaf's bytes straight from its tensor into a temporary file, which then
replaces the target (os.replace).  Unknown ext codes, dtypes and type
bytes, truncated or trailing bytes raise ValueError naming the byte
offset: nothing is guessed.  Tensors are read and written little-endian,
as flax writes them on the hosts it runs on.
"""

from __future__ import annotations

import mmap
import os
import os.path as op
import struct
from typing import Any, BinaryIO, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30          # flax's, in bytes
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "uint32": torch.uint32,
    "bool": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    """Recursive descent over a buffer; `base` is the buffer object the
    tensors are built over (the mapping), `buf` a memoryview of it."""

    def __init__(self, base, buf: memoryview):
        self.base, self.buf, self.pos = base, buf, 0

    def fail(self, what: str, at: int):
        raise ValueError(f"msgpack: {what} at byte {at}")

    def take(self, n: int) -> int:
        """Advance past n bytes; return where they start."""
        at = self.pos
        if n < 0 or at + n > len(self.buf):
            self.fail(f"truncated ({n} bytes wanted, "
                      f"{len(self.buf) - at} left)", at)
        self.pos = at + n
        return at

    def unpack(self, fmt: str):
        at = self.take(struct.calcsize(fmt))
        return struct.unpack_from(fmt, self.buf, at)[0]

    def text(self, n: int) -> str:
        at = self.take(n)
        try:
            return bytes(self.buf[at:at + n]).decode("utf-8")
        except UnicodeDecodeError:
            self.fail("invalid UTF-8 string", at)

    def obj(self) -> Any:
        at = self.pos
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack((">B", ">H", ">I")[b - 0xC4])
            s = self.take(n)
            return bytes(self.buf[s:s + n])
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self.ext(self.unpack(">b"), n, at)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q",
                                ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4), at)
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.mapping(self.unpack(">H" if b == 0xDE else ">I"), at)
        self.fail(f"type byte 0x{b:02x} is not msgpack", at)

    def mapping(self, n: int, at: int):
        out = {}
        for _ in range(n):
            k = self.obj()
            if isinstance(k, (dict, list)):
                self.fail("a map key that is a map or a list", at)
            out[k] = self.obj()
        if out.get(CHUNKED) is True:
            return self.unchunk(out, at)
        return out

    def ext(self, code: int, n: int, at: int):
        start = self.take(n)
        end = self.pos
        self.pos = start
        if code == EXT_NDARRAY:
            out = self.ndarray(at)
        elif code == EXT_NPSCALAR:
            out = self.ndarray(at)
            if out.dim():
                self.fail(f"a scalar of shape {list(out.shape)}", at)
            out = out.item()
        elif code == EXT_COMPLEX:
            pair = self.obj()
            if not (isinstance(pair, list) and len(pair) == 2):
                self.fail("a complex that is no (real, imag) pair", at)
            out = complex(pair[0], pair[1])
        else:
            self.fail(f"unknown ext code {code}", at)
        if self.pos != end:
            self.fail(f"ext {code} payload of {n} bytes read as "
                      f"{self.pos - start}", at)
        return out

    def ndarray(self, at: int) -> torch.Tensor:
        b = self.unpack("B")
        if b != 0x93:
            self.fail("an ndarray that is no (shape, dtype, bytes) triple",
                      at)
        shape = self.obj()
        if not (isinstance(shape, list)
                and all(isinstance(d, int) and d >= 0 for d in shape)):
            self.fail(f"ndarray shape {shape!r}", at)
        name = self.obj()
        if isinstance(name, bytes):
            name = name.decode("ascii", "replace")
        dt = DTYPES.get(name) if isinstance(name, str) else None
        if dt is None:
            self.fail(f"dtype {name!r} (known: {sorted(DTYPES)})", at)
        b = self.unpack("B")
        if b not in (0xC4, 0xC5, 0xC6):
            self.fail("ndarray data that is no bin object", at)
        nbytes = self.unpack((">B", ">H", ">I")[b - 0xC4])
        off = self.take(nbytes)
        count = int(np.prod(shape, dtype=np.int64))
        if count * dt.itemsize != nbytes:
            self.fail(f"{nbytes} bytes for shape {shape} of {name}", at)
        if count == 0:
            return torch.empty(shape, dtype=dt)
        return torch.frombuffer(self.base, dtype=dt, count=count,
                                offset=off).view(shape)

    def unchunk(self, d: dict, at: int) -> torch.Tensor:
        shape, chunks = d.get("shape"), d.get("chunks")
        if not (isinstance(shape, dict) and isinstance(chunks, dict)):
            self.fail("a chunked array without shape and chunks maps", at)
        try:
            dims = [shape[str(i)] for i in range(len(shape))]
            parts = [chunks[str(i)] for i in range(len(chunks))]
        except KeyError:
            self.fail("a chunked array's keys are not 0..n-1", at)
        if not parts or not all(isinstance(p, torch.Tensor) and p.dim() == 1
                                for p in parts):
            self.fail("a chunked array's chunks are not flat arrays", at)
        flat = torch.cat(parts) if len(parts) > 1 else parts[0]
        if flat.numel() != int(np.prod(dims, dtype=np.int64)):
            self.fail(f"chunks of {flat.numel()} elements for shape {dims}",
                      at)
        return flat.view(dims)


def loads(data) -> Any:
    """The object msgpack-encoded in `data` (bytes, bytearray or a
    writable buffer), tensors as views of it where it is writable."""
    base = data if not isinstance(data, bytes) else bytearray(data)
    r = _Reader(base, memoryview(base).cast("B"))
    out = r.obj()
    if r.pos != len(r.buf):
        r.fail(f"{len(r.buf) - r.pos} bytes after the object", r.pos)
    return out


def load(path: str) -> Any:
    """The tree in a msgpack file, every array a tensor over a private
    mapping of the file (an empty file raises ValueError)."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise ValueError(f"msgpack: {path} is empty, at byte 0")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return loads(mm)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes((v,))
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes((tag,)) + struct.pack(fmt, v)
    else:
        for tag, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                               (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << bits):
                return bytes((tag,)) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _sized(n: int, fix: Tuple[int, int], tags: Tuple[int, ...],
           what: str) -> bytes:
    """A length header: the fix form (its base, its limit) or the 8/16/32-
    bit form (tags; None where msgpack has no such form)."""
    if fix and n < fix[1]:
        return bytes((fix[0] | n,))
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            return bytes((tag,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: a {what} of {n} too long")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB), "string") + b


def _bin_header(n: int) -> bytes:
    return _sized(n, (), (0xC4, 0xC5, 0xC6), "bin")


def _ext_header(code: int, n: int) -> bytes:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fix is not None:
        return bytes((fix, code))
    return _sized(n, (), (0xC7, 0xC8, 0xC9), "ext") + bytes((code,))


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        if x.dtype.name not in DTYPES:
            raise ValueError(f"msgpack: dtype {x.dtype.name} is not "
                             f"written (known: {sorted(DTYPES)})")
        return torch.from_numpy(x if x.flags.c_contiguous else x.copy())
    if x.dtype not in NAMES:
        raise ValueError(f"msgpack: dtype {x.dtype} is not written")
    return x.detach().contiguous().to("cpu")  # a transpose on its device


class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f

    def put(self, x, chunkable: bool = True):
        """Write x; `chunkable`: x and the maps under it are reached from
        the top through maps only, where flax chunks an oversized leaf."""
        w = self.f.write
        if isinstance(x, np.generic):     # before float: np.float64 is one
            self.ndarray(EXT_NPSCALAR, _as_tensor(np.asarray(x)))
        elif x is None:
            w(b"\xc0")
        elif isinstance(x, bool):
            w(b"\xc3" if x else b"\xc2")
        elif isinstance(x, int):
            w(_int(x))
        elif isinstance(x, float):
            w(b"\xcb" + struct.pack(">d", x))
        elif isinstance(x, str):
            w(_str(x))
        elif isinstance(x, (bytes, bytearray)):
            w(_bin_header(len(x)) + bytes(x))
        elif isinstance(x, dict):
            # flax writes a map's keys sorted (its tree_map copy sorts them)
            self.mapping(sorted(x.items()), chunkable)
        elif isinstance(x, (list, tuple)):
            w(_sized(len(x), (0x90, 16), (None, 0xDC, 0xDD), "array"))
            for v in x:
                self.put(v, chunkable=False)
        elif isinstance(x, (torch.Tensor, np.ndarray)):
            t = _as_tensor(x)
            if chunkable and t.numel() * t.element_size() > MAX_CHUNK_SIZE:
                n = max(1, MAX_CHUNK_SIZE // t.element_size())
                flat = t.reshape(-1)
                self.mapping([
                    (CHUNKED, True),
                    ("shape", {str(i): d for i, d in enumerate(t.shape)}),
                    ("chunks", {str(i): flat[s:s + n] for i, s in
                                enumerate(range(0, flat.numel(), n))})],
                    False, ordered=True)
            else:
                self.ndarray(EXT_NDARRAY, t)
        else:
            raise ValueError(f"msgpack: cannot write a {type(x).__name__}")

    def mapping(self, items, chunkable: bool, ordered: bool = False):
        """A map of (key, value) pairs; `ordered`: the nested maps keep
        their insertion order too (flax's chunk maps are not sorted)."""
        self.f.write(_sized(len(items), (0x80, 16), (None, 0xDE, 0xDF),
                            "map"))
        for k, v in items:
            self.put(k)
            if ordered and isinstance(v, dict):
                self.mapping(list(v.items()), False, ordered=True)
            else:
                self.put(v, chunkable)

    def ndarray(self, code: int, t: torch.Tensor):
        """The ext header, the (shape, dtype, bytes) triple's header, then
        the tensor's bytes straight from its memory."""
        nbytes = t.numel() * t.element_size()
        head = (b"\x93" + _sized(t.dim(), (0x90, 16), (None, 0xDC, 0xDD),
                                 "array")
                + b"".join(_int(d) for d in t.shape) + _str(NAMES[t.dtype])
                + _bin_header(nbytes))
        self.f.write(_ext_header(code, len(head) + nbytes) + head)
        if nbytes:
            self.f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def dump(path: str, tree: Any) -> None:
    """Write `tree` (maps, lists, tensors or numpy arrays, numpy scalars,
    Python scalars, strings) to `path` atomically: streamed into
    `path + '.tmp'`, which then replaces `path`."""
    os.makedirs(op.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            _Writer(f).put(tree)
        os.replace(tmp, path)
    finally:
        if op.exists(tmp):
            os.remove(tmp)

