"""vitcap_tpu_torch's host C++ (vitcap_tpu_torch/native/, built with g++
at first use) against the JAX package's copies and against the port's
plain Python versions, on the CPU:

- the `.lineidx.8b` scanner: bytes identical to the JAX package's native
  scanner and to the offsets of the port's Python line scan
  (generate_lineidx), also on an empty TSV, one without a final newline
  and one whose lines cross the scanner's 8 MB reads;
- CIDEr-D: the native scorer within rtol 1e-9 of the JAX package's native
  scorer and of the port's Python scorer (VITCAP_NATIVE_CIDER=0);
- the image pipeline: exact mode bit-identical to the JAX package's and to
  the PIL path, fast mode bit-identical to the JAX package's fast mode, a
  PNG row through PIL, LoadImage's arrays equal on both backends;
- the library build: its output under build/vitcap_tpu_torch/host, keyed
  by the source, and a failed build raising with g++'s output.
"""

import base64
import io
import json
import os

import numpy as np
import pytest

from vitcap_tpu.data import native_image as JNI
from vitcap_tpu.data import native_tsv as JNT
from vitcap_tpu.data import transforms as JX
from vitcap_tpu.evals import native_cider as JNC

from vitcap_tpu_torch import native as TN
from vitcap_tpu_torch.data import dataset as TD
from vitcap_tpu_torch.data import native_image as TNI
from vitcap_tpu_torch.data import native_tsv as TNT
from vitcap_tpu_torch.data import transforms as TX
from vitcap_tpu_torch.data import tsv as TS
from vitcap_tpu_torch.evals import metrics as TM
from vitcap_tpu_torch.evals import native_cider as TNC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the .lineidx.8b scanner
# ---------------------------------------------------------------------------

def _tsv_bytes(case):
    rs = np.random.RandomState(len(case))
    if case == "empty":
        return b""
    if case == "no_final_newline":
        return b"a\t1\nb\t2\nlast\trow"
    if case == "blank_lines":
        return b"\n\nk\tv\n\n"
    if case == "long_lines":                 # lines across the 8 MB reads
        big = [b"x" * n for n in (5 << 20, 7 << 20, 3)]
        return b"\n".join([b"k0\t" + big[0], b"k1\t" + big[1], b"k2\t"
                           + big[2], b"tail"]) + b"\n"
    rows = [f"k{i}\t{json.dumps({'c': 'w' * rs.randint(0, 40)})}\t"
            f"{'é' * rs.randint(0, 5)}" for i in range(200)]
    return ("\n".join(rows) + "\n").encode()


@pytest.mark.parametrize("case", ["rows", "empty", "no_final_newline",
                                  "blank_lines", "long_lines"])
def test_lineidx_8b_matches_jax_and_python_scan(tmp_path, case):
    data = _tsv_bytes(case)
    tsv = tmp_path / "a.tsv"
    tsv.write_bytes(data)
    n = TNT.build_lineidx_8b(str(tsv), str(tmp_path / "port.8b"))
    assert JNT.build_lineidx_8b(str(tsv), str(tmp_path / "jax.8b")) == n
    got = (tmp_path / "port.8b").read_bytes()
    assert got == (tmp_path / "jax.8b").read_bytes()
    TS.generate_lineidx(str(tsv), str(tmp_path / "a.lineidx"))
    text = (tmp_path / "a.lineidx").read_text().split()
    assert got == np.asarray([int(t) for t in text], "<u8").tobytes()
    assert n == len(text)
    # TSVFile builds the same sidecar itself and reads every row with it
    os.remove(tmp_path / "a.lineidx")
    f = TS.TSVFile(str(tsv))
    assert len(f) == n
    assert (tmp_path / "a.lineidx.8b").read_bytes() == got
    if case == "rows":
        assert f[3][0] == "k3" and f[199][0] == "k199"


def test_lineidx_8b_unreadable_tsv_raises(tmp_path):
    with pytest.raises(OSError, match="could not index"):
        TNT.build_lineidx_8b(str(tmp_path / "missing.tsv"),
                             str(tmp_path / "missing.lineidx.8b"))


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

WORDS = [f"w{i}" for i in range(60)] + ["a", "the", "dog", "on"]


def _corpus(seed, n_img, n_ref):
    rs = np.random.RandomState(seed)

    def cap():
        return " ".join(rs.choice(WORDS, rs.randint(1, 16)))
    gts = {f"k{i}": [cap() for _ in range(n_ref)] for i in range(n_img)}
    res = {k: [cap()] for k in gts}
    first = next(iter(gts))
    res[first] = [gts[first][2]]                     # an exact match
    return gts, res


@pytest.mark.parametrize("seed,n_img,n_ref", [(0, 6, 5), (1, 192, 5),
                                              (2, 40, 3), (3, 1, 5)])
def test_ciderd_native_matches_jax_and_python(monkeypatch, seed, n_img,
                                              n_ref):
    """192 x 5 is SCST's shape (B=64, K=2: 192 captions, 5 references)."""
    gts, res = _corpus(seed, n_img, n_ref)
    mean, got = TNC.ciderd_corpus_native(gts, res)
    jmean, want = JNC.ciderd_corpus_native(gts, res)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(mean, jmean, rtol=1e-9)
    # CiderD routes corpus mode to the native scorer ...
    assert TM.CiderD().compute_score(gts, res)[1].tolist() == got.tolist()
    # ... and VITCAP_NATIVE_CIDER=0 to the Python scorer, its plain version
    monkeypatch.setenv("VITCAP_NATIVE_CIDER", "0")
    pmean, plain = TM.CiderD().compute_score(gts, res)
    np.testing.assert_allclose(got, plain, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(mean, pmean, rtol=1e-9)
    if n_img > 1:
        assert got[0] == got.max()


def test_ciderd_routes(monkeypatch):
    """corpus df with n = 4 only: other n-gram orders stay Python."""
    calls = []
    real = TNC.ciderd_corpus_native
    monkeypatch.setattr(TNC, "ciderd_corpus_native",
                        lambda *a: calls.append(1) or real(*a))
    gts, res = _corpus(4, 5, 5)
    TM.CiderD().compute_score(gts, res)
    TM.CiderD(n=3).compute_score(gts, res)
    assert calls == [1]


# ---------------------------------------------------------------------------
# the image pipeline
# ---------------------------------------------------------------------------

def _jpeg(h, w, seed=0, quality=90, fmt="JPEG"):
    """A smooth seeded image with mild noise (a photo's spectrum, so the
    DCT-scaled decode stays close to the exact one)."""
    from PIL import Image
    rs = np.random.RandomState(seed)
    small = rs.randint(0, 256, (max(h // 40, 2), max(w // 40, 2), 3))
    img = np.asarray(Image.fromarray(small.astype(np.uint8)).resize(
        (w, h), Image.BICUBIC)).astype(np.int16)
    img = np.clip(img + rs.randint(-6, 7, img.shape), 0, 255)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, format=fmt,
                                               quality=quality)
    return buf.getvalue()


def _pil(data, crop, pct):
    from PIL import Image
    t = TX.TestImageTransform(crop_size=crop, crop_pct=pct, emit_uint8=True,
                              backend="pil")
    return t(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("hw,crop,pct", [((480, 640), 384, 1.0),
                                         ((400, 480), 384, 1.0),
                                         ((500, 500), 384, 1.0),
                                         ((300, 200), 128, 0.875),
                                         ((640, 480), 224, 0.9)])
def test_decode_exact_and_fast_match_jax(hw, crop, pct):
    data = _jpeg(*hw, seed=sum(hw))
    resize = int(np.floor(crop / pct))
    exact = TNI.decode_resize_center_crop(data, resize, crop)
    np.testing.assert_array_equal(
        exact, JNI.decode_resize_center_crop(data, resize, crop))
    np.testing.assert_array_equal(exact, _pil(data, crop, pct))
    fast = TNI.decode_resize_center_crop(data, resize, crop, fast=True)
    np.testing.assert_array_equal(
        fast, JNI.decode_resize_center_crop(data, resize, crop, fast=True))
    # the JAX package's own bound for its fast mode (tests/test_data_layer
    # .py test_fast_mode_close): within 1.5 LSB on average, few outliers
    d = np.abs(fast.astype(np.int16) - exact)
    assert d.mean() < 1.5 and (d > 25).mean() < 1e-3
    # the pieces: decode at a DCT scale, resize a window
    for min_short in (0, resize):
        np.testing.assert_array_equal(TNI.decode_jpeg(data, min_short),
                                      JNI.decode_jpeg(data, min_short))


def test_transform_payloads_and_normalised_output():
    """A PNG payload returns None (the caller decodes it with PIL); the
    float output equals the PIL path's, also for an image upscaled to the
    crop; backend 'pil' never takes the native path."""
    native = TX.TestImageTransform(crop_size=128)
    pil = TX.TestImageTransform(crop_size=128, backend="pil")
    png = _jpeg(240, 320, fmt="PNG")
    assert native.from_jpeg_bytes(png) is None
    assert JX.TestImageTransform(crop_size=128).from_jpeg_bytes(png) is None
    from PIL import Image
    for data in (_jpeg(240, 320), _jpeg(60, 80)):
        out = native.from_jpeg_bytes(data)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(
            out, pil(Image.open(io.BytesIO(data)).convert("RGB")))
    assert pil.from_jpeg_bytes(data) is None
    assert TNI.decode_jpeg(b"not an image") is None


@pytest.mark.parametrize("fast", [False, True])
def test_load_image_matches_on_both_backends(tmp_path, fast):
    """LoadImage over a TSV of JPEG and PNG rows: the native backend's
    arrays equal the PIL backend's (exact mode) or the JAX package's
    LoadImage (fast mode), row by row."""
    from vitcap_tpu.data import dataset as JD
    rows = [(f"k{i}", "0", base64.b64encode(_jpeg(
        200 + 8 * i, 260, seed=i, fmt="PNG" if i == 2 else "JPEG")).decode())
        for i in range(4)]
    TS.tsv_writer(rows, str(tmp_path / "d" / "test.tsv"))
    kw = dict(crop_size=96, emit_uint8=True, fast_decode=fast)
    load_native = TD.LoadImage("d", "test", TX.TestImageTransform(**kw),
                               data_root=str(tmp_path))
    load_pil = TD.LoadImage("d", "test", TX.TestImageTransform(
        backend="pil", **kw), data_root=str(tmp_path))
    load_jax = JD.LoadImage("d", "test", JX.TestImageTransform(**kw),
                            data_root=str(tmp_path))
    for i in range(len(rows)):
        got = load_native({"idx_img": i})["image"]
        np.testing.assert_array_equal(got, load_jax({"idx_img": i})["image"])
        if not fast or i == 2:
            np.testing.assert_array_equal(
                got, load_pil({"idx_img": i})["image"])


# ---------------------------------------------------------------------------
# the library build
# ---------------------------------------------------------------------------

def test_libraries_build_under_the_build_directory():
    for name in ("tsvtools", "cider", "imageproc"):
        TN.library(name)
        path = TN.library_path(name)
        assert path.is_file()
        assert path.parent.parent == TN.BUILD_ROOT
        assert TN.build_info[name]["path"] == str(path)
    assert TN.SOURCES == \
        TN.BUILD_ROOT.parents[2] / "vitcap_tpu_torch" / "native"
    assert TN.BUILD_ROOT.parents[1].name == "build"
    for src in ("tsvtools.cpp", "cider.cpp", "imageproc.cpp"):
        assert (TN.SOURCES / src).is_file()


def test_failed_build_raises_with_gcc_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(TN, "SOURCES", tmp_path)
    monkeypatch.setattr(TN, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setitem(TN.SIGNATURES, "broken", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building "
                       "'broken'") as err:
        TN.library("broken")
    assert "broken.cpp:1:" in str(err.value) and "error" in str(err.value)
    assert not list((tmp_path / "build").rglob("*.so"))
    (tmp_path / "missing_header.cpp").write_text(
        "#include <no_such_header_here.h>\n")
    with pytest.raises(RuntimeError, match="no_such_header_here.h"):
        TN.library("missing_header")
