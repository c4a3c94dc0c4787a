"""Host-side image pipeline: base64 JPEG decode + train/test transforms,
the port's copy of vitcap_tpu/data/transforms.py.  Images decode with
PIL, imported where an image is decoded, except where the test transform
takes a JPEG payload itself (`image_backend: native`, the default):
then the fused C++ decode + resize + crop of data/native_image.py runs,
bit-exact with the PIL path (`image_fast_decode`: libjpeg's DCT-scaled
decode, within 1 LSB on average).

Numpy/PIL re-implementation of the reference torchvision chains (same
distributions, RGB layout, NHWC float32 or uint8 output):

- train: RandomResizedCrop(crop, scale=(0.08,1)) + ColorJitter(.4,.4,.4) +
  RandomHorizontalFlip + normalize(0.5,0.5)
  (reference src/data_layer/transform.py:52-81, called with bgr2rgb=True);
- test: Resize(floor(crop/crop_pct), bicubic) + CenterCrop(crop) + normalize
  (reference src/pipelines/uni_pipeline.py:1233-1265; live YAML crop_pct=1.0,
  test_crop_size=384).

Outputs NHWC (the patch-embed consumes NHWC directly)
instead of the reference's NCHW.
"""

from __future__ import annotations

import base64
import io
import math
import random
from typing import Optional, Tuple

import numpy as np

def img_from_base64(s: str) -> "Image.Image":
    """base64 jpeg/png -> PIL RGB (reference img_from_base64 + BGR2RGB)."""
    from PIL import Image
    raw = base64.b64decode(s)
    img = Image.open(io.BytesIO(raw))
    return img.convert("RGB")


def encoded_from_img(img, fmt: str = "JPEG", quality: int = 95) -> str:
    """PIL image (or HWC uint8 array) -> base64 string, the inverse of
    img_from_base64 (reference `encoded_from_img`, used when writing image
    TSVs)."""
    from PIL import Image
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img.astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format=fmt, quality=quality)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def normalize_to_array(img: "Image.Image", mean=0.5, std=0.5) -> np.ndarray:
    x = np.asarray(img, dtype=np.float32) / 255.0
    return (x - mean) / std                           # HWC RGB


def random_resized_crop_params(rng: random.Random, w: int, h: int,
                               scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
                               ) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params semantics."""
    area = w * h
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch)
            j = rng.randint(0, w - cw)
            return i, j, ch, cw
    # fallback: center crop at in-range aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def color_jitter(rng: random.Random, img: "Image.Image",
                 brightness=0.4, contrast=0.4, saturation=0.4
                 ) -> "Image.Image":
    """torchvision ColorJitter: the three ops applied in random order with
    factors from U[max(0,1-v), 1+v]."""
    from PIL import ImageEnhance
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f2 = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation > 0:
        f3 = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


class TrainImageTransform:
    """Inception-style train augmentation -> (crop, crop, 3) float32."""

    def __init__(self, crop_size: int = 384, small_scale: float = 0.08,
                 mean: float = 0.5, std: float = 0.5,
                 seed: Optional[int] = None, patchify: int = 0,
                 emit_uint8: bool = False):
        self.crop_size = crop_size
        self.scale = (small_scale, 1.0)
        self.mean, self.std = mean, std
        self.rng = random.Random(seed)
        self.patchify = patchify
        self.emit_uint8 = emit_uint8

    def __call__(self, img: "Image.Image") -> np.ndarray:
        from PIL import Image
        w, h = img.size
        i, j, ch, cw = random_resized_crop_params(self.rng, w, h, self.scale)
        img = img.crop((j, i, j + cw, i + ch)).resize(
            (self.crop_size, self.crop_size), Image.BILINEAR)
        img = color_jitter(self.rng, img)
        if self.rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.emit_uint8:
            # raw bytes to the device; normalization folds into the patch
            # projection (models/layers.py patch_embed) — 4x less
            # host->device traffic, zero host float math
            return np.asarray(img, dtype=np.uint8)
        arr = normalize_to_array(img, self.mean, self.std)
        if self.patchify:
            from ..models.layers import patchify_host
            arr = patchify_host(arr, self.patchify)
        return arr


class TestImageTransform:
    """Resize(floor(crop/crop_pct), bicubic) + CenterCrop(crop).

    `backend="native"` (the default, as in the JAX package) routes JPEG
    payloads through the fused C++ decode+resize+crop (`from_jpeg_bytes`,
    data/native_image.py), bit-exact with the PIL path; its library is
    built here, and a host that cannot build it raises (use
    backend="pil" there).  `fast_decode=True` adds libjpeg's DCT-domain
    scaled decode (output within 1 LSB of exact on average)."""

    def __init__(self, crop_size: int = 384, crop_pct: float = 1.0,
                 mean: float = 0.5, std: float = 0.5, patchify: int = 0,
                 emit_uint8: bool = False, backend: str = "native",
                 fast_decode: bool = False):
        self.crop_size = crop_size
        self.resize_size = int(math.floor(crop_size / crop_pct))
        self.mean, self.std = mean, std
        self.patchify = patchify
        self.emit_uint8 = emit_uint8
        self.backend = backend
        self.fast_decode = fast_decode
        if backend == "native":          # build it now: raises if it cannot
            from ..native import library
            library("imageproc")

    def _finish(self, arr_u8: np.ndarray) -> np.ndarray:
        if self.emit_uint8:
            return arr_u8
        arr = (arr_u8.astype(np.float32) / 255.0 - self.mean) / self.std
        if self.patchify:
            from ..models.layers import patchify_host
            arr = patchify_host(arr, self.patchify)
        return arr

    def from_jpeg_bytes(self, data: bytes) -> Optional[np.ndarray]:
        """The fused native path for a raw payload; None when the backend
        is PIL or libjpeg refuses the payload (a PNG row): the caller then
        decodes with PIL and calls the transform."""
        if self.backend != "native":
            return None
        from .native_image import decode_resize_center_crop
        out = decode_resize_center_crop(data, self.resize_size,
                                        self.crop_size, fast=self.fast_decode)
        return None if out is None else self._finish(out)

    def __call__(self, img: "Image.Image") -> np.ndarray:
        from PIL import Image
        w, h = img.size
        # torchvision Resize(int): short side -> size, keep aspect
        if w < h:
            nw, nh = self.resize_size, int(self.resize_size * h / w)
        else:
            nw, nh = int(self.resize_size * w / h), self.resize_size
        img = img.resize((nw, nh), Image.BICUBIC)
        left = (nw - self.crop_size) // 2
        top = (nh - self.crop_size) // 2
        img = img.crop((left, top, left + self.crop_size,
                        top + self.crop_size))
        return self._finish(np.asarray(img, dtype=np.uint8))
