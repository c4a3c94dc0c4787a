"""Build and load the CUDA kernels of vitcap_tpu_torch/csrc.

The sources are compiled with nvcc, one process per source, all started
together, and linked into one shared library with a plain C interface,
loaded with ctypes.  The build runs at the first CUDA call into a
directory under the checkout's ``build/`` (listed in .gitignore), keyed by a
hash of the sources and the flags, so an edited kernel is rebuilt and an
unchanged one is reused.  A failed build raises with nvcc's output; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vitcap_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
_OPERAND = [_P, _L, _L, _L]   # base pointer, batch, head and row strides
_BIAS = [_P, _L, _L]          # base pointer (or null), batch and head strides
# C entry points and their argument types (see csrc/*.cu)
SIGNATURES = {
    # a, w, bias, res, out, pre, M, N, K, dtype, gelu, f32_sum, out_f32,
    # bias_first, seed, thresh, inv, which, rows_per_image, split, stream
    "vc_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _U,
                _U, _F, _I, _I, _I, _P],
    # x, g, b, y, mean, rsig, rows, H, eps, in_dtype, out_dtype, vec, stream
    "vc_layer_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    # q, k, v (each pointer, batch, head and row strides), bias (pointer,
    # batch and head strides), out, B, Lp, H, nh, l_actual, scale, seed,
    # thresh, inv, nh_total, head_offset (the dropout salt's global head),
    # online, the bf16 instance's head columns, dtype, stream
    "vc_attention": [*_OPERAND * 3, *_BIAS, _P, _I, _I, _I, _I, _I, _F, _U,
                     _U, _F, _I, _I, _I, _I, _I, _P],
    # q, k, v, g (each pointer, batch, head and row strides), bias (pointer,
    # batch and head strides), dq, dk, dv, mlr, B, Lp, H, nh, l_actual,
    # scale, seed, thresh, inv, nh_total, head_offset, dtype, stream
    "vc_attention_bwd": [*_OPERAND * 4, *_BIAS, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _F, _U, _U, _F, _I, _I, _I, _P],
    # qkv, cap_k, cap_v, ctx_k, ctx_v, bias, t, out, B, nb, beam groups,
    # S, A, H, nh, scale, dtype, ranks, keys per rank, key capacity, stream
    "vc_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _F, _I, _I, _I, _I, _P],
    # (the *_kernel_info) index, name buffer, its length, int[5]
    # (threads, registers, local bytes, shared bytes per block, resident
    # blocks per SM)
    "vc_gemm_kernel_info": [_I, ctypes.c_char_p, _I, ctypes.POINTER(_I)],
    "vc_attention_kernel_info": [_I, ctypes.c_char_p, _I,
                                 ctypes.POINTER(_I)],
    "vc_attention_bwd_kernel_info": [_I, ctypes.c_char_p, _I,
                                     ctypes.POINTER(_I)],
    "vc_layer_norm_kernel_info": [_I, ctypes.c_char_p, _I,
                                  ctypes.POINTER(_I)],
    # ... and the decode geometry: the beams of one launch row, S, A, the
    # cluster kernel's ranks and key capacity
    "vc_decode_attention_kernel_info": [_I, ctypes.c_char_p, _I,
                                        ctypes.POINTER(_I), _I, _I, _I, _I,
                                        _I],
}


def dtype_code(dtype) -> int:
    """The csrc dtype code (VC_F32 / VC_BF16 in common.cuh)."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


# the last build's facts, for chip_smoke.py: seconds, path, and per kernel
# the registers and spill bytes ptxas reports
build_info: dict = {}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libvitcap_kernels.so"
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = str(out_dir / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
               "-o", tmp] + [obj for _, obj, _ in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)            # atomic: no half-written library
        (out_dir / "nvcc.log").write_text(log)
    elif (out_dir / "nvcc.log").exists():
        log = (out_dir / "nvcc.log").read_text()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      ptxas=_ptxas_kernels(log))
    return lib


def _ptxas_kernels(log: str) -> list:
    """ptxas -v output -> [{'name', 'registers', 'spill_bytes'}], one
    entry per compiled kernel (mangled names)."""
    kernels = []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernels.append({"name": ln.split("'")[1], "registers": 0,
                            "spill_bytes": 0})
        elif kernels and "bytes spill stores" in ln:
            kernels[-1]["spill_bytes"] = int(
                ln.split("bytes spill stores")[0].split(",")[-1])
        elif kernels and "Used " in ln and "registers" in ln:
            kernels[-1]["registers"] = int(ln.split("Used ")[1].split()[0])
    return kernels


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {rc}")


def launch_info(entry: str, *extra: int) -> list:
    """The launch configuration of the kernels that the C function `entry`
    (vc_gemm_kernel_info, vc_attention_kernel_info,
    vc_attention_bwd_kernel_info, vc_layer_norm_kernel_info;
    vc_decode_attention_kernel_info with its geometry as `extra`) lists, on
    the current CUDA device: one dict per compiled kernel with its name,
    threads per block, registers per thread, local (spill) bytes per
    thread, shared bytes per block and resident blocks per SM
    (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = getattr(library(), entry)
    keys = ("threads", "registers", "local_bytes", "shared_bytes",
            "blocks_per_sm")
    kernels = []
    while True:
        name = ctypes.create_string_buffer(96)
        info = (ctypes.c_int * len(keys))()
        rc = fn(len(kernels), name, len(name), info, *extra)
        if rc == -1:
            return kernels
        check(rc, entry)
        kernels.append({"name": name.value.decode(), **dict(zip(keys, info))})
