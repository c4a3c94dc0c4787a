"""vitcap_tpu_torch's own data files and loose helpers against the JAX
package's: every file under vitcap_tpu_torch/assets byte-equal to its
vitcap_tpu/assets original; pert_collate, encoded_from_img,
MeanSigmaMetricLogger, get_mpi_rank / get_mpi_size and the file helpers
of utils/common.py held to the JAX functions on the same inputs."""

import logging
import os
import os.path as op
from pathlib import Path

import numpy as np
import pytest

from vitcap_tpu.data import dataset as JDS
from vitcap_tpu.data import transforms as JTR
from vitcap_tpu.utils import common as JC
from vitcap_tpu.utils import meters as JME
from vitcap_tpu_torch.data import dataset as TDS
from vitcap_tpu_torch.data import transforms as TTR
from vitcap_tpu_torch.utils import common as TC
from vitcap_tpu_torch.utils import meters as TME

ROOT = Path(__file__).resolve().parents[1]
JAX_ASSETS = ROOT / "vitcap_tpu" / "assets"
PORT_ASSETS = ROOT / "vitcap_tpu_torch" / "assets"
ASSETS = sorted(str(p.relative_to(JAX_ASSETS))
                for p in JAX_ASSETS.rglob("*") if p.is_file())


def test_the_port_ships_every_asset():
    port = sorted(str(p.relative_to(PORT_ASSETS))
                  for p in PORT_ASSETS.rglob("*") if p.is_file())
    assert port == ASSETS and len(ASSETS) == 12


@pytest.mark.parametrize("name", ASSETS)
def test_asset_copy_is_byte_equal(name):
    assert (PORT_ASSETS / name).read_bytes() == (JAX_ASSETS / name) \
        .read_bytes()
    assert TC.asset_path(*Path(name).parts) == str(PORT_ASSETS / name)


def test_asset_path_and_default_vocab_read_the_port():
    from vitcap_tpu_torch.data.tokenization import DEFAULT_VOCAB
    assert DEFAULT_VOCAB == PORT_ASSETS / "VILT-L12-H784-uncased_16_384" \
        / "vocab.txt"
    assert TC.resolve_asset("./yaml/vinvl_label.json") == str(
        PORT_ASSETS / "vinvl_label.json")


@pytest.mark.parametrize("prob", [0.0, 0.3, 0.99])
def test_pert_collate_matches_jax(prob):
    rs = np.random.RandomState(1)
    samples = [{"image": rs.randn(3, 4, 4).astype(np.float32),
                "input_ids": rs.randint(0, 9, 6), "key": f"k{i}",
                "score": float(i)} for i in range(7)]
    got = TDS.pert_collate(samples, prob, np.random.RandomState(5))
    want = JDS.pert_collate(samples, prob, np.random.RandomState(5))
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    assert got["matched"][int(7 * prob) + 1:].all()


@pytest.mark.parametrize("fmt, quality", [("JPEG", 95), ("JPEG", 70),
                                          ("PNG", 95)])
def test_encoded_from_img_matches_jax(fmt, quality):
    from PIL import Image
    arr = np.random.RandomState(2).randint(0, 256, (20, 24, 3)) \
        .astype(np.uint8)
    for img in (arr, Image.fromarray(arr)):
        got = TTR.encoded_from_img(img, fmt, quality)
        assert got == JTR.encoded_from_img(img, fmt, quality)
    back = np.asarray(TTR.img_from_base64(got))
    assert back.shape == arr.shape
    if fmt == "PNG":
        np.testing.assert_array_equal(back, arr)


def test_mean_sigma_metric_logger_matches_jax():
    got, want = TME.MeanSigmaMetricLogger(), JME.MeanSigmaMetricLogger()
    rs = np.random.RandomState(3)
    for _ in range(9):
        kw = {"fwd": rs.rand(), "bwd": rs.rand() * 10}
        got.update(**kw)
        want.update(**kw)
    got.update(once=2.5)
    want.update(once=2.5)
    assert got.get_info() == want.get_info()
    assert str(got) == str(want)
    assert got.get_info()["once"]["sigma"] == 0.0


@pytest.mark.parametrize("env", [{}, {"RANK": "3", "WORLD_SIZE": "4"},
                                 {"OMPI_COMM_WORLD_RANK": "1",
                                  "OMPI_COMM_WORLD_SIZE": "2"}])
def test_mpi_rank_and_size_match_jax(monkeypatch, env):
    for k in ("RANK", "WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert TC.get_mpi_rank() == JC.get_mpi_rank()
    assert TC.get_mpi_size() == JC.get_mpi_size()


def test_dict_path_helpers_match_jax():
    def tree():
        return {"a": {"b": {"c": 1}, "d": 2}, "e": {}, "f": {"g": {"h": 3}}}
    assert list(TC.iter_dict_paths(tree())) == \
        list(JC.iter_dict_paths(tree()))
    for path in ("a$b$c", "f$g$h", "a$d", "x$y", "a$b$zz", "e"):
        got, want = tree(), tree()
        TC.dict_remove_path(got, path)
        JC.dict_remove_path(want, path)
        assert got == want, path


def test_file_helpers_match_jax(tmp_path):
    for mod in (TC, JC):
        f = str(tmp_path / mod.__name__ / "sub" / "x.txt")
        mod.write_to_file("one\n", f)
        mod.write_to_file("two\n", f, append=True)
        assert mod.read_to_buffer(f) == b"one\ntwo\n"
        with mod.exclusive_open_to_read(f) as fp:
            assert fp.read() == "one\ntwo\n"
        assert op.isfile(f + ".lock")
        with mod.acquire_lock(str(tmp_path / "l.LOCK")) as fp:
            assert not fp.closed
        mod.ensure_remove_dir(str(tmp_path / mod.__name__))
        assert not op.exists(tmp_path / mod.__name__)
        mod.ensure_remove_dir(str(tmp_path / "missing"))
    for value in ("abc", {"b": 1, "a": [1, 2]}, 3.5, None):
        assert TC.hash_sha1(value) == JC.hash_sha1(value)


def test_acquire_lock_defaults_to_the_temporary_directory(monkeypatch,
                                                          tmp_path):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    lock = TC.acquire_lock()
    assert lock.lock_path == str(tmp_path / "vitcap_lockfile.LOCK")
    with lock:
        assert op.isfile(lock.lock_path)


def test_retry_and_try_once_match_jax(monkeypatch, caplog):
    for mod in (TC, JC):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        calls = []

        def flaky(n, x=0):
            calls.append(n)
            if len(calls) < n:
                raise OSError("not yet")
            return x + len(calls)
        assert mod.limited_retry_agent(3, flaky, 3, x=10) == 13
        calls.clear()
        with pytest.raises(OSError):
            mod.limited_retry_agent(2, flaky, 3)
        assert len(calls) == 2

        @mod.try_once
        def boom():
            raise ValueError("x")
        with caplog.at_level(logging.ERROR):
            assert boom() is None
        assert "ignored failure in boom" in caplog.text
        assert mod.try_once(lambda: 4)() == 4
