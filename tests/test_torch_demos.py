"""The port's entry points `python -m vitcap_tpu_torch.demo`,
`vitcap_tpu_torch.demo_e2e` and `vitcap_tpu_torch.tools.precompute_tags`
against the repository's demo.py, demo_e2e.py and tools/precompute_tags.py
(the JAX package's), on the CPU (--device cpu).

One tiny model (hidden 32, 4 layers, the shipped vocab; an LM bias spread
so the captions are words, not an early SEP) saved by the JAX package as
a msgpack `.ckpt` and as a reference-named `.pt`; one seeded JPEG.  Each
demo gives the JAX script's caption and tags (the printed lines equal,
the confidence within its 3 printed decimals), demo_e2e with and without
a detections JSON; precompute_tags writes the JAX tool's sidecar bytes.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import demo as JDemo                                          # noqa: E402
import demo_e2e as JDemoE2E                                   # noqa: E402
from vitcap_tpu.models import vitcap as JM                    # noqa: E402
from vitcap_tpu.models.config import ModelConfig as JCfg      # noqa: E402
from vitcap_tpu.solver import checkpoint_bridge as JB         # noqa: E402
from vitcap_tpu.solver import checkpointing as JC             # noqa: E402

from vitcap_tpu_torch import demo as TDemo                    # noqa: E402
from vitcap_tpu_torch import demo_e2e as TDemoE2E             # noqa: E402
from vitcap_tpu_torch.data.tokenization import DEFAULT_VOCAB  # noqa: E402
from vitcap_tpu_torch.data.tsv import tsv_writer              # noqa: E402
from vitcap_tpu_torch.tools import precompute_tags as TTags   # noqa: E402

ENC = {"hidden_size": 32, "num_attention_heads": 4, "intermediate_size": 64,
       "num_hidden_layers": 4, "max_position_embeddings": 96,
       "type_vocab_size": 2, "vocab_size": 30522, "layer_norm_eps": 1e-12,
       "attention_probs_dropout_prob": 0.0}
CROP = "32"


def _jax_tool():
    """The repository's tools/precompute_tags.py, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_precompute_tags", os.path.join(ROOT, "tools",
                                            "precompute_tags.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The encoder folder, a JPEG, the JAX weights as `.ckpt` and `.pt`,
    and a detections file."""
    root = tmp_path_factory.mktemp("demos")
    enc = root / "enc"
    enc.mkdir()
    (enc / "config.json").write_text(json.dumps(ENC))
    shutil.copy(DEFAULT_VOCAB, enc / "vocab.txt")
    from PIL import Image
    rs = np.random.RandomState(0)
    Image.fromarray(rs.randint(0, 255, (48, 64, 3), np.uint8)).save(
        root / "photo.jpg")
    cfg = JCfg(hidden_size=32, num_attention_heads=4, intermediate_size=64,
               num_hidden_layers=4, vocab_size=30522, tag_vocab_size=30522,
               max_position_embeddings=96, img_size=32)
    params = jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(0), cfg))
    bias = (rs.randn(cfg.vocab_size) * 2.0).astype(np.float32)
    bias[cfg.sep_token_id] = -8.0
    params["cls"]["decoder"]["bias"] = bias
    JC.save_state(str(root / "model.ckpt"), {"params": params})
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in
                          JB.params_to_torch_state_dict(params).items()}},
               root / "model.pt")
    (root / "det.json").write_text(json.dumps({"detections": [
        {"class": "dog", "conf": 0.97, "rect": [0, 0, 30, 30]},
        {"class": "bench", "conf": 0.8, "rect": [5, 5, 40, 20]},
        {"class": "dog", "conf": 0.6, "rect": [1, 1, 29, 29]}]}))
    return root, enc


def _printed(main, argv):
    """(main(argv)'s return value, its stdout lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue().splitlines()


def _split_conf(lines):
    """The printed lines with the caption line's confidence taken out."""
    rest, confs = [], []
    for line in lines:
        if line.startswith("caption:") and "(" in line:
            head, _, tail = line.rpartition("(")
            rest.append(head)
            confs.append(float(tail.split()[-1].rstrip(")")))
        else:
            rest.append(line)
    return rest, confs


def _same_output(jax_main, port_main, argv):
    want, wlines = _printed(jax_main, argv)
    got, glines = _printed(port_main, argv + ["--device", "cpu"])
    assert got == want and got.strip()
    (wl, wc), (gl, gc) = _split_conf(wlines), _split_conf(glines)
    assert gl == wl
    np.testing.assert_allclose(gc, wc, atol=1.5e-3)
    return got


@pytest.mark.parametrize("ckpt", ["model.ckpt", "model.pt"])
@pytest.mark.parametrize("beams", ["1", "2"])
def test_demo_gives_the_jax_caption_and_tags(setup, ckpt, beams):
    root, enc = setup
    _same_output(JDemo.main, TDemo.main,
                 ["--checkpoint", str(root / ckpt),
                  "--image", str(root / "photo.jpg"),
                  "--encoder-dir", str(enc), "--crop-size", CROP,
                  "--beams", beams, "--topk-tags", "8"])


@pytest.mark.parametrize("ckpt", ["model.ckpt", "model.pt"])
@pytest.mark.parametrize("detections", [True, False],
                         ids=["detections", "detector_free"])
def test_demo_e2e_gives_the_jax_caption(setup, ckpt, detections):
    root, enc = setup
    argv = ["--checkpoint", str(root / ckpt),
            "--image", str(root / "photo.jpg"),
            "--encoder-dir", str(enc), "--crop-size", CROP, "--beams", "2",
            "--min-constraints", "1", "--max-constraints", "2"]
    if detections:
        argv += ["--detections", str(root / "det.json")]
    _same_output(JDemoE2E.main, TDemoE2E.main, argv)


def test_no_hierarchy_filter_matches_jax():
    names = ["dog", "person", "man", "dog", "tree", "bench"]
    scores = np.array([0.9, 0.95, 0.0, 0.5, 0.7, 0.8], np.float32)
    boxes = np.zeros((6, 4), np.float32)
    for n in (1, 2, 3, 5):
        assert (TDemoE2E._NoHierarchyFilter(n)(boxes, names, scores)
                == JDemoE2E._NoHierarchyFilter(n)(boxes, names, scores))


def test_demos_default_to_the_card(setup, monkeypatch):
    """--device defaults to cuda; without a card both demos raise."""
    root, enc = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--checkpoint", str(root / "model.ckpt"),
            "--image", str(root / "photo.jpg"), "--encoder-dir", str(enc),
            "--crop-size", CROP]
    for main in (TDemo.main, TDemoE2E.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


CAPTIONS = ["A dog runs on the green grass.", "Two cats sit on a red mat",
            "a man in a blue shirt walks down the busy street"]


@pytest.mark.parametrize("pos", ["JJ,NN,NNP", "NN"])
def test_precompute_tags_writes_the_jax_sidecar(tmp_path, pos):
    """Both tools over copies of one dataset: the same sidecar bytes."""
    src = tmp_path / "src" / "tiny"
    tsv_writer(((f"im{i}", json.dumps([{"caption": c},
                                       {"caption": CAPTIONS[i - 1]}]))
                for i, c in enumerate(CAPTIONS)),
               str(src / "train.caption.tsv"))
    outs = []
    for name, main in (("jax", _jax_tool().main), ("port", TTags.main)):
        data = tmp_path / name / "tiny"
        shutil.copytree(src, data)
        out, _ = _printed(main, ["--data", str(data), "--split", "train",
                                 "--pos", pos])
        assert out == str(data / "train.caption_tags.tsv")
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and outs[0].count(b"\n") == len(CAPTIONS)
