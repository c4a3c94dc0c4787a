"""vitcap_tpu_torch's host layers against the JAX package's, on the same
inputs: the YAML/Config machinery and the CLI argument parser, the
WordPiece tokenizer, the seeded tensorizers, the TSV files and their
indexes (bytes), one batch from each package's transform -> dataset ->
DataLoader chain (arrays equal), and the two model helpers the pipeline
calls (init_tag_blocks_from_encoder exactly; resize_word_embeddings
keeping every old row), plus the trunk table of the pipeline's model_cfg.
"""

import base64
import json
import os
import random

import numpy as np
import pytest
import torch

import jax
from vitcap_tpu.data import dataset as JD
from vitcap_tpu.data import tensorizers as JT
from vitcap_tpu.data import tokenization as JK
from vitcap_tpu.data import transforms as JX
from vitcap_tpu.data import tsv as JS
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.pipelines import caption_pipeline as JCP
from vitcap_tpu.utils import common as JC
from vitcap_tpu.utils import meters as JMe

from vitcap_tpu_torch.data import dataset as TD
from vitcap_tpu_torch.data import tensorizers as TT
from vitcap_tpu_torch.data import tokenization as TK
from vitcap_tpu_torch.data import transforms as TX
from vitcap_tpu_torch.data import tsv as TS
from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.pipelines import caption_pipeline as TCP
from vitcap_tpu_torch.solver import checkpoint_bridge as TB
from vitcap_tpu_torch.utils import common as TCo
from vitcap_tpu_torch.utils import meters as TMe

from test_torch_pipeline import _param, make_dataset

CAPTIONS = [
    "A man riding a wave on top of a surfboard.",
    "Ce n'est pas une pipe — café, naïve, résumé!",
    "unicode: 你好 world 123; 東京タワー at night",
    "weird   spacing\tand\nnewlines (vinvl) -- 'dog', \"cat\"",
    "[CLS] special [SEP] tokens [MASK] kept",
    "supercalifragilisticexpialidocious Ünïcödé ÅNGSTRÖM",
]


@pytest.fixture(scope="module")
def toks():
    return (JK.BertTokenizer(str(TK.DEFAULT_VOCAB)),
            TK.BertTokenizer(str(TK.DEFAULT_VOCAB)))


# ---------------------------------------------------------------------------
# utils: Config, YAML with _base_, the CLI's arguments, meters
# ---------------------------------------------------------------------------

def test_yaml_base_and_config_match_jax(tmp_path):
    TCo.write_to_yaml_file({"x": 1, "y": {"z": 2, "q": [1, 2]}},
                           str(tmp_path / "base.yaml"))
    TCo.write_to_yaml_file({"_base_": "base.yaml", "y": {"z": 5}, "w": 9},
                           str(tmp_path / "child.yaml"))
    (tmp_path / "grand.yaml").write_text("_base_: [child.yaml]\nv: 3\n")
    for name in ("child.yaml", "grand.yaml"):
        got = TCo.load_from_yaml_file(str(tmp_path / name))
        assert got == JC.load_from_yaml_file(str(tmp_path / name))
    assert got == {"x": 1, "y": {"z": 5, "q": [1, 2]}, "w": 9, "v": 3}
    JC.write_to_yaml_file({"x": 1, "y": {"z": 2, "q": [1, 2]}},
                          str(tmp_path / "jbase.yaml"))
    assert (tmp_path / "base.yaml").read_bytes() == \
        (tmp_path / "jbase.yaml").read_bytes()
    cfgs = [m.Config({"a": 1, "nest": {"k": 2}}, {"a": 10})
            for m in (JC, TCo)]
    for cfg in cfgs:
        cfg.b = 5
        cfg.set("nest$j", 4)
    j, t = cfgs
    assert t.as_dict() == j.as_dict()
    assert (t.a, t.get("nest$k"), t.get("nest$j"), t.b) == \
        (j.a, j.get("nest$k"), j.get("nest$j"), j.b) == (10, 2, 4, 5)
    assert t.has("nest$k") and not t.has("nest$x")
    with pytest.raises(AttributeError, match="unknown config key"):
        t.unknown_key
    assert t.get("unknown_key", 7) == 7


def test_parse_general_args_matches_jax(tmp_path):
    TCo.write_to_yaml_file({"_base_": "b.yaml", "param": {"lr": 1.0},
                            "type": "t"}, str(tmp_path / "c.yaml"))
    TCo.write_to_yaml_file({"param": {"bs": 4, "x": {"y": 1}}},
                           str(tmp_path / "b.yaml"))
    argv = ["-c", str(tmp_path / "c.yaml"), "-p", "param: {lr: 2.0}",
            "-bp", base64.b64encode(b"param: {x: {z: 2}}").decode()]
    got = TCo.parse_general_args(argv)
    assert got == JC.parse_general_args(argv)
    assert got == {"type": "t", "param": {"lr": 2.0, "bs": 4,
                                          "x": {"y": 1, "z": 2}}}


def test_dict_paths_worth_create_and_assets(tmp_path):
    d = {}
    TCo.dict_set_path_value(d, "a$b$c", 3)
    assert d == {"a": {"b": {"c": 3}}}
    assert TCo.dict_has_path(d, "a$b$c") and not TCo.dict_has_path(d, "a$x")
    assert TCo.dict_get_path_value(d, "a$x", with_default=True,
                                   default=7) == 7
    with pytest.raises(KeyError):
        TCo.dict_get_path_value(d, "a$x")
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_text("1")
    assert TCo.worth_create(str(a), str(b)) == JC.worth_create(str(a),
                                                               str(b))
    b.write_text("2")
    os.utime(a, (1, 1))
    assert not TCo.worth_create(str(a), str(b))
    # the port reads its own copies of the JAX package's data files
    for name in ("VILT-L12-H784-uncased_16_384", "vinvl_label.json"):
        mine = TCo.asset_path(name)
        assert mine == os.path.join(os.path.dirname(os.path.dirname(
            TCo.__file__)), "assets", name)
        assert sorted(os.listdir(mine)) == sorted(os.listdir(
            JC.asset_path(name))) if os.path.isdir(mine) else \
            open(mine, "rb").read() == open(JC.asset_path(name), "rb").read()
        assert TCo.resolve_asset(f"./yaml/{name}") == mine
        assert JC.resolve_asset(f"./yaml/{name}") == JC.asset_path(name)
    TCo.execute_func({"from": "vitcap_tpu_torch.utils.common",
                      "import": "ensure_directory",
                      "param": {"path": str(tmp_path / "made")}})
    assert (tmp_path / "made").is_dir()
    p = TCo.save_parameters({"a": 1, "f": object()}, str(tmp_path / "run"))
    assert TCo.load_latest_parameters(str(tmp_path / "run"))["a"] == 1
    assert os.path.isfile(p)


def test_meters_match_jax():
    ml = [JMe.MetricLogger(), TMe.MetricLogger()]
    for m in ml:
        for v in (3.0, 1.0, 2.0, 8.0):
            m.update(loss=v, time=v / 2)
    assert ml[1].get_info() == ml[0].get_info()
    assert str(ml[1]) == str(ml[0])
    assert ml[1].loss.median == 2.5 and ml[1].time.count == 4


# ---------------------------------------------------------------------------
# tokenizer and tensorizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", CAPTIONS)
def test_tokenizer_matches_jax(toks, text):
    jt, tt = toks
    got = tt.tokenize(text)
    assert got == jt.tokenize(text)
    assert tt.convert_tokens_to_ids(got) == jt.convert_tokens_to_ids(got)
    ids = tt.encode(text)
    assert tt.decode(ids) == jt.decode(ids)
    assert tt.convert_ids_to_tokens(ids) == jt.convert_ids_to_tokens(ids)


def test_caption_decoder_is_the_tokenizers_decode(toks):
    jt, _ = toks
    dec = TK.CaptionDecoder()
    ids = [101, 1037, 3899, 2003, 2770, 0, 102, 103, 7592, 2229]
    assert dec.decode(ids) == jt.decode(ids)
    assert dec.decode(ids, skip_special_tokens=False) == \
        jt.decode(ids, skip_special_tokens=False)
    assert dec.vocab_size == 30522


@pytest.mark.parametrize("is_train", [True, False])
def test_caption_tensorizer_matches_jax(toks, is_train):
    """The same seeded RNG: the masked positions, the 80/10/10 corruption
    and every array are equal."""
    outs = []
    for mod, tok in ((JT, toks[0]), (TT, toks[1])):
        kw = dict(max_seq_length=30, max_seq_a_length=12, is_train=is_train,
                  rng=random.Random(5), mask_prob=0.5, max_masked_tokens=4)
        t = mod.CaptionTensorizer(tok, **kw)
        outs.append([t.tensorize_ab(c, text_b=b)
                     for c in CAPTIONS for b in ("", "dog cat")])
    for j, t in zip(*outs):
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype


def test_tagger_tensorizers_match_jax(toks):
    labels = [{"class": "dog", "conf": 0.9}, {"class": "hot dog",
                                              "conf": 0.5},
              {"class": "cat", "conf": 0.1}, {"class": "car"}]
    for encode in ("nltk", "bert"):
        j = JT.CaptionTaggerTensorizer(toks[0], encode=encode)
        t = TT.CaptionTaggerTensorizer(toks[1], encode=encode)
        for cap in (None, CAPTIONS[0], CAPTIONS[2]):
            np.testing.assert_array_equal(t.tensorize(labels, cap)["label"],
                                          j.tensorize(labels, cap)["label"])
    l2i = {"dog": 0, "hot dog": 1, "cat": 2, "car": 3}
    np.testing.assert_array_equal(
        TT.VinvlTaggerTensorizer(l2i).tensorize(labels)["label"],
        JT.VinvlTaggerTensorizer(l2i).tensorize(labels)["label"])
    assert TT.pos_tag_caption(CAPTIONS[0]) == JT.pos_tag_caption(CAPTIONS[0])


# ---------------------------------------------------------------------------
# TSV files
# ---------------------------------------------------------------------------

def test_tsv_files_match_jax_bytes(tmp_path):
    """tsv_writer's .tsv, .lineidx and .lineidx.8b; concat, reorder and
    the COCO json of both packages, byte for byte; both readers agree."""
    rows = [(f"k{i}", json.dumps([{"caption": c}]), "é" * i)
            for i, c in enumerate(CAPTIONS)]
    for m, d in ((JS, "j"), (TS, "t")):
        base = tmp_path / d
        m.tsv_writer(rows, str(base / "a.tsv"))
        m.tsv_writer(rows[:2], str(base / "b.tsv"))
        m.concat_tsv_files([str(base / "a.tsv"), str(base / "b.tsv")],
                           str(base / "c.tsv"))
        m.reorder_tsv_keys(str(base / "c.tsv"),
                           [r[0] for r in reversed(rows)],
                           str(base / "r.tsv"))
        m.iter_caption_to_json(((r[0], r[1]) for r in rows),
                               str(base / "cap.json"))
    for name in ("a.tsv", "a.lineidx", "a.lineidx.8b", "c.tsv",
                 "c.lineidx.8b", "r.tsv", "r.lineidx.8b", "cap.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    f = TS.TSVFile(str(tmp_path / "t" / "r.tsv"))
    assert len(f) == len(rows)
    assert f[0] == list(rows[-1]) and f.seek_first_column(1) == "k4"
    # an index the port builds itself (no sidecars): the native scanner
    # writes the .lineidx.8b that the JAX package's writer wrote
    os.remove(tmp_path / "t" / "a.lineidx")
    os.remove(tmp_path / "t" / "a.lineidx.8b")
    g = TS.TSVFile(str(tmp_path / "t" / "a.tsv"))
    assert [g[i] for i in range(len(g))] == [list(r) for r in rows]
    assert not (tmp_path / "t" / "a.lineidx").exists()
    assert (tmp_path / "t" / "a.lineidx.8b").read_bytes() == \
        (tmp_path / "j" / "a.lineidx.8b").read_bytes()
    TS.delete_tsv_files([str(tmp_path / "t" / "b.tsv")])
    assert not (tmp_path / "t" / "b.lineidx.8b").exists()


def test_tsv_dataset_naming_matches_jax(tmp_path):
    for m in (JS, TS):
        ds = m.TSVDataset("coco", data_root=str(tmp_path))
        assert ds.get_data("train", "caption", "vinvl").endswith(
            "train.caption.vvinvl.tsv")
    TS.tsv_writer([("a", "1")], str(tmp_path / "coco" / "train.label.v2.tsv"))
    TS.tsv_writer([("a", "1")], str(tmp_path / "coco" / "train.label.tsv"))
    for v in (None, 2, -1):
        assert TS.TSVDataset("coco", str(tmp_path)).get_data(
            "train", "label", v) == JS.TSVDataset(
                "coco", str(tmp_path)).get_data("train", "label", v)


# ---------------------------------------------------------------------------
# transforms -> dataset -> DataLoader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_dataset(root)
    return root


def _seed(mp, cp):
    orig = cp.CaptionUniPipeline.train_caption_tensorizer

    def tensorizer(self):
        t = orig(self)
        t.rng = random.Random(9)
        return t

    class Transform(cp.TrainImageTransform):
        def __init__(self, *a, **kw):
            kw["seed"] = 10
            super().__init__(*a, **kw)
    mp.setattr(cp.CaptionUniPipeline, "train_caption_tensorizer",
               tensorizer)
    mp.setattr(cp, "TrainImageTransform", Transform)


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("feed", ["uint8", "patchified", "hwc_float"])
def test_loader_batch_matches_jax(data_root, monkeypatch, is_train, feed):
    """The first batch of each package's pipeline loader (seeded RNGs, one
    thread), arrays equal, for every image feed."""
    batches = []
    for cp, extra in ((JCP, {}), (TCP, {"device": "cpu"})):
        _seed(monkeypatch, cp)
        pip = cp.CaptionUniPipeline(**_param(data_root, "out", image_feed=feed,
                                             test_batch_size=3, **extra))
        batches.append(next(iter(pip.get_data_loader(is_train=is_train))))
    j, t = batches
    assert j.keys() == t.keys()
    for k in j:
        if isinstance(j[k], np.ndarray):
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            assert list(t[k]) == list(j[k]), k


def test_transforms_match_jax():
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    for fmt in ("JPEG", "PNG"):
        b64 = JX.encoded_from_img(img, fmt=fmt)
        pj, pt = JX.img_from_base64(b64), TX.img_from_base64(b64)
        np.testing.assert_array_equal(np.asarray(pt), np.asarray(pj))
    for kw in (dict(emit_uint8=True), dict(patchify=16),
               dict(crop_pct=0.875)):
        j = JX.TestImageTransform(crop_size=32, backend="pil", **kw)(pj)
        t = TX.TestImageTransform(crop_size=32, **kw)(pt)
        np.testing.assert_array_equal(t, j)
    j = JX.TrainImageTransform(crop_size=32, seed=3)
    t = TX.TrainImageTransform(crop_size=32, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(t(pt), j(pj))
    # the native decoder's fast mode (DCT-scaled decode) on a JPEG large
    # enough to scale: the JAX package's bytes, within 1 LSB of exact
    from PIL import Image
    big = np.asarray(Image.fromarray(
        rs.randint(0, 256, (6, 8, 3)).astype(np.uint8)).resize(
            (420, 300), Image.BICUBIC))
    jpeg = base64.b64decode(JX.encoded_from_img(big, fmt="JPEG"))
    kw = dict(crop_size=64, emit_uint8=True, backend="native")
    fast = TX.TestImageTransform(fast_decode=True, **kw).from_jpeg_bytes(jpeg)
    np.testing.assert_array_equal(
        fast, JX.TestImageTransform(fast_decode=True, **kw).from_jpeg_bytes(
            jpeg))
    exact = TX.TestImageTransform(**kw).from_jpeg_bytes(jpeg)
    assert not np.array_equal(fast, exact)
    assert np.abs(fast.astype(np.int16) - exact).mean() < 1.0


def test_samplers_match_jax():
    ds = list(range(11))
    for m in (JD, TD):
        s = m.DistributedSampler(ds, 1, 0, shuffle=True)
        bs = m.BatchSampler(s, 4, drop_last=True)
        m.out = list(m.IterationBasedBatchSampler(bs, 7, start_iter=2))
    assert TD.out == JD.out and len(TD.out) == 5
    with pytest.raises(RuntimeError, match="no batches"):
        list(TD.IterationBasedBatchSampler(
            TD.BatchSampler(TD.DistributedSampler(ds[:2], 1, 0), 4,
                            drop_last=True), 3))


# ---------------------------------------------------------------------------
# the model helpers and the trunk table the pipeline uses
# ---------------------------------------------------------------------------

def _jax_and_port(**kw):
    jcfg, cfg = jax_tiny_config(**kw), TC.tiny_config(**kw)
    params = jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, params, TB.load_jax_params(TM.ViTCAP(cfg), params)


def test_init_tag_blocks_from_encoder_matches_jax():
    """Exact, and real copies: the tag blocks do not alias the trunk."""
    jcfg, cfg, params, model = _jax_and_port(num_hidden_layers=4,
                                             split_blocks=2)
    want = TB.flatten_params(jax.tree_util.tree_map(
        np.asarray, JM.init_tag_blocks_from_encoder(params, jcfg)))
    TM.init_tag_blocks_from_encoder(model, cfg)
    got = TB.state_to_jax_flat(model.state_dict())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tag = model.bert.encoder.tag_blocks[0]
    trunk = model.bert.encoder.blocks[2]
    for (_, a), (_, b) in zip(tag.named_parameters(),
                              trunk.named_parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("new", [140, 100])
def test_resize_word_embeddings_keeps_rows(tied, new):
    """The old rows (and the LM head's bias and untied decoder rows) kept
    exactly as the JAX package keeps them; new rows drawn at std 0.02
    within 2 sigma, new bias entries 0."""
    jcfg, cfg, params, model = _jax_and_port(tie_weights=tied)
    want = TB.flatten_params(jax.tree_util.tree_map(
        np.asarray, JM.resize_word_embeddings(params, jcfg, new)))
    TM.resize_word_embeddings(model, new, torch.Generator().manual_seed(1))
    got = TB.state_to_jax_flat(model.state_dict())
    assert got.keys() == want.keys()
    n = min(new, cfg.vocab_size)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.startswith(("embeddings/word", "cls/decoder")):
            rows = (slice(None), slice(0, n)) if want[k].ndim == 2 \
                and k.startswith("cls") else slice(0, n)
            np.testing.assert_array_equal(got[k][rows], want[k][rows],
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    w = model.bert.embeddings.word_embeddings.weight
    assert w.shape == (new, cfg.hidden_size)
    if new > cfg.vocab_size:
        extra = w[cfg.vocab_size:]
        assert extra.abs().max() <= 0.04 and 0.005 < extra.std() < 0.03
        assert (model.cls.predictions.bias[cfg.vocab_size:] == 0).all()


def test_vit_trunk_table_matches_jax_registry():
    """vit_trunk resolves every ViT of the JAX registry to its spec's
    (patch, width, depth) through the port's model zoo; another name
    falls back to patch 32 or 16 as the JAX pipeline does; a CNN of the
    zoo (part 1's or 2's, part 2c's HRNet too) raises ValueError."""
    from vitcap_tpu.models import registry as R
    vits = [n for n in R.list_models()
            if isinstance(R.model_spec(n), R.VisionModelSpec)]
    assert len(vits) == 34
    for name in vits:
        spec = R.model_spec(name)
        assert TC.vit_trunk(f"VitEmb_{name}") == \
            (spec.patch_size, spec.hidden_size, spec.depth)
    assert TC.vit_trunk("VitEmb_my_patch32_trunk") == (32, None, None)
    assert TC.vit_trunk("VitEmb_my_trunk") == (16, None, None)
    with pytest.raises(ValueError, match="no ViT"):
        TC.vit_trunk("VitEmb_hrnet_w18")
    for cnn in ("resnet50", "efficientnet_b0", "densenet121"):
        with pytest.raises(ValueError, match="no ViT"):
            TC.vit_trunk(f"VitEmb_{cnn}")


def test_flagship_model_cfg_matches_jax():
    """model_cfg at the shipped VILT-L12-H784-uncased_16_384 config: the
    flagship (12 trunk + 4 tag blocks, H 768, vocab 30522), field by
    field; and at the vinvl tag vocab."""
    for kw in ({}, {"category": "vinvl",
                    "image_encoder_type": "VitEmb_vit_base_patch32_384",
                    "train_crop_size": 384, "max_seq_a_length": 20}):
        j = JCP.CaptionUniPipeline(**kw).model_cfg
        t = TCP.CaptionUniPipeline(device="cpu", **kw).model_cfg
        want = {k: v for k, v in j.__dict__.items()}
        got = {k: v for k, v in t.__dict__.items() if k in want}
        assert got == {k: v for k, v in want.items() if k in got}
        assert len(got) >= 40
    assert t.num_hidden_layers == 12 and t.patch_size == 32
    assert t.tag_vocab_size == 2027
