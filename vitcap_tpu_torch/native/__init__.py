"""Build and load the port's host C++ libraries: the sources beside this
file (tsvtools.cpp, the `.lineidx.8b` scanner; cider.cpp, the CIDEr-D
scorer; imageproc.cpp, the fused JPEG decode + bicubic resize + center
crop, linked with libjpeg; zstd.cpp, the zstd frame decoder and CRC-32C
of the orbax snapshots, which links no library).

These run on the CPU: each is compiled with g++ into a shared library with
a plain C interface, loaded with ctypes.  A library is built at its first
use into a directory under the checkout's ``build/vitcap_tpu_torch/host/``
(listed in .gitignore), keyed by a hash of its source and the flags, and
moved into place by an atomic rename, so concurrent processes never load a
half-written file.  A failed build raises with g++'s output; no caller
swaps in another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

SOURCES = Path(__file__).resolve().parent
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build" /
              "vitcap_tpu_torch" / "host")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = {"imageproc": ["-ljpeg"]}        # linked after the source

_P = ctypes.c_void_p
_I = ctypes.c_int
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SZ = ctypes.c_size_t
# each library's C entry points: {name: (argtypes, restype)}
SIGNATURES = {
    "tsvtools": {
        # tsv path, sidecar path -> lines indexed, or -1
        "build_lineidx_8b": ([ctypes.c_char_p, ctypes.c_char_p],
                             ctypes.c_longlong),
    },
    "cider": {
        # hyp words, hyp offsets, ref words, ref offsets, ref offsets per
        # image, images, sigma, scores out
        "ciderd_corpus": ([_I32P, _I64P, _I32P, _I64P, _I64P,
                           ctypes.c_int64, ctypes.c_double,
                           ctypes.POINTER(ctypes.c_double)], None),
    },
    "imageproc": {
        # bytes, length, min short side, &w, &h -> 0 or a parse error
        "vc_jpeg_dims": ([ctypes.c_char_p, ctypes.c_size_t, _I,
                          ctypes.POINTER(_I), ctypes.POINTER(_I)], _I),
        # bytes, length, min short side, out (h x w x 3), w, h -> 0 or error
        "vc_jpeg_decode": ([ctypes.c_char_p, ctypes.c_size_t, _I, _P, _I,
                            _I], _I),
        # src, sw, sh, rw, rh, cx, cy, cw, ch, dst
        "vc_resize_bicubic_crop": ([_P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                                   None),
    },
    "zstd": {
        # src, length, dst, capacity, &written, &error offset, counters (or
        # None), message buffer, its size -> 0 or -1
        "vc_zstd_decode": ([_P, _SZ, _P, _SZ, ctypes.POINTER(_SZ),
                            ctypes.POINTER(_SZ), _P, ctypes.c_char_p, _SZ],
                           _I),
        "vc_zstd_counter_count": ([], _I),
        # bytes, length, running crc (0 to start) -> CRC-32C
        "vc_crc32c": ([_P, _SZ, ctypes.c_uint32], ctypes.c_uint32),
    },
}

# per library: the seconds its build (or load) took and its path
build_info: Dict[str, dict] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _flags(name: str) -> list:
    return CXX_FLAGS + LIBS.get(name, [])


def library_path(name: str) -> Path:
    """Where `name`'s library for the current source and flags lives."""
    src = SOURCES / f"{name}.cpp"
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _build(name: str, out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH: the host library "
                           f"{name!r} cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, str(SOURCES / f"{name}.cpp"), "-o", tmp,
           *LIBS.get(name, [])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed building {name!r} "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)                 # atomic: no half-written library


def library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load the host library `name`
    ('tsvtools', 'cider', 'imageproc' or 'zstd')."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            t0 = time.perf_counter()
            path = library_path(name)
            built = not path.exists()
            if built:
                _build(name, path)
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "built": built, "path": str(path)}
            _libs[name] = lib
    return _libs[name]
