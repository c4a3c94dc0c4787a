"""The native image pipeline (vitcap_tpu_torch/native/imageproc.cpp), the
port's copy of vitcap_tpu/data/native_image.py: fused JPEG decode +
PIL-compatible antialiased bicubic resize + center crop.

The predict path's host cost is JPEG decode and resize; the native path
decodes with libjpeg (exact mode: at full size, bit-exact with PIL's
decode + resize + crop; fast mode: at the smallest libjpeg M/8 DCT scale
whose short side covers the resize target, within 1 LSB of exact on
average) and resizes only the crop window.  A payload libjpeg refuses
(a PNG row) returns None, and the caller decodes it with PIL; a library
that cannot be built raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..native import library


def _dims(lib, data: bytes, min_short: int):
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.vc_jpeg_dims(data, len(data), min_short, ctypes.byref(w),
                        ctypes.byref(h)):
        return None
    return w.value, h.value


def decode_jpeg(data: bytes, min_short: int = 0) -> Optional[np.ndarray]:
    """JPEG bytes -> (h, w, 3) uint8 RGB, decoded at the smallest libjpeg
    M/8 scale whose short side stays >= min_short (0 = full size).  None
    when the payload is not a JPEG."""
    lib = library("imageproc")
    wh = _dims(lib, data, min_short)
    if wh is None:
        return None
    w, h = wh
    out = np.empty((h, w, 3), np.uint8)
    if lib.vc_jpeg_decode(data, len(data), min_short,
                          out.ctypes.data_as(ctypes.c_void_p), w, h):
        return None
    return out


def resize_bicubic_crop(img: np.ndarray, resize_wh, crop_xywh) -> np.ndarray:
    """PIL-compatible antialiased bicubic resize of uint8 HWC `img` to
    (rw, rh), materialising only the (cx, cy, cw, ch) crop window."""
    lib = library("imageproc")
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) uint8, got {img.shape}")
    sh, sw = img.shape[:2]
    rw, rh = resize_wh
    cx, cy, cw, ch = crop_xywh
    if not (0 <= cx and cx + cw <= rw and 0 <= cy and cy + ch <= rh):
        raise ValueError(f"crop {crop_xywh} outside the resized {resize_wh}")
    dst = np.empty((ch, cw, 3), np.uint8)
    lib.vc_resize_bicubic_crop(
        img.ctypes.data_as(ctypes.c_void_p), sw, sh, rw, rh,
        cx, cy, cw, ch, dst.ctypes.data_as(ctypes.c_void_p))
    return dst


def decode_resize_center_crop(data: bytes, resize_size: int, crop_size: int,
                              fast: bool = False) -> Optional[np.ndarray]:
    """The fused predict-path transform: decode -> short-side resize to
    `resize_size` (torchvision Resize(int) semantics) -> center crop to
    (crop_size, crop_size).  Returns uint8 HWC, or None for a payload
    libjpeg refuses or an image smaller than the crop (the caller's PIL
    path handles both).

    fast=False decodes at full size: bit-exact with the PIL decode +
    resize + crop.  fast=True decodes at the smallest libjpeg M/8 DCT
    scale covering `resize_size` (mean deviation under 1 LSB, the class
    of PIL's Image.draft)."""
    lib = library("imageproc")
    # target dims follow the ORIGINAL image size (torchvision Resize(int)
    # computes them before any decode-time scaling)
    wh = _dims(lib, data, 0)
    if wh is None:
        return None
    w, h = wh
    if w < h:
        nw, nh = resize_size, int(resize_size * h / w)
    else:
        nw, nh = int(resize_size * w / h), resize_size
    left = (nw - crop_size) // 2
    top = (nh - crop_size) // 2
    if left < 0 or top < 0:
        return None                  # image smaller than the crop: PIL
    img = decode_jpeg(data, min_short=resize_size if fast else 0)
    if img is None:
        return None
    return resize_bicubic_crop(img, (nw, nh),
                               (left, top, crop_size, crop_size))
