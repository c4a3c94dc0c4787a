"""vitcap_tpu_torch's pipelines and CLI against the JAX package's, on the
CPU: the same YAML parameters drive `pipeline_train_eval_multi` of both
packages over one tiny synthetic TSV dataset (6 images, the shipped
vocab), from one basemodel (the JAX package's init_params written as a
reference `.pt`).  Both sides get the same seeded tensorizer and train
transform RNGs and one loader thread, so their batches are the same.

Tolerances: per-step loss rtol 2e-5; the final snapshot's parameters
1e-4 of each tensor's scale (3 AdamW steps of f32 sums in another order);
predict TSV keys and captions equal, confs rtol 1e-5; the `.report`
numbers within 1e-9 (identical captions give identical scores).  Then
the port alone: the CLI from a YAML file, the cached re-run, resume from
the iteration-2 snapshot, a 2-step SCST run, and the keys that raise.
"""

import base64
import contextlib
import io
import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

import jax
import run as JR
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.pipelines import caption_pipeline as JCP
from vitcap_tpu.solver import checkpoint_bridge as JB
from vitcap_tpu.solver import checkpointing as JCK
from vitcap_tpu.solver import train_step as JTS

from vitcap_tpu_torch import run as TR
from vitcap_tpu_torch.data.tokenization import DEFAULT_VOCAB
from vitcap_tpu_torch.data.tsv import tsv_reader, tsv_writer
from vitcap_tpu_torch.pipelines import caption_pipeline as TCP
from vitcap_tpu_torch.solver import checkpoint_bridge as TB
from vitcap_tpu_torch.solver import train_step as TTS

KEYS = [f"im{i}" for i in range(6)]
CAPS = ["a dog runs on the grass", "a cat sits on a red mat",
        "a man walks down the street", "a bird flies over the water",
        "a car drives on the road", "a child plays with a ball"]
TEST = [{"test_data": "tinycoco", "test_split": "test"}]


def _b64(rng):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (40, 48, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def make_dataset(root):
    """data/tinycoco/{train,test}.* TSVs and a tiny text-encoder folder
    (tiny dims, the shipped vocab) under root."""
    d = os.path.join(root, "data", "tinycoco")
    rng = np.random.RandomState(0)
    for split in ["train", "test"]:
        tsv_writer(((k, "0", _b64(rng)) for k in KEYS),
                   f"{d}/{split}.tsv")
        tsv_writer(((k, json.dumps([{"height": 40, "width": 48}]))
                    for k in KEYS), f"{d}/{split}.hw.tsv")
        tsv_writer(((k, json.dumps([{"caption": CAPS[i]},
                                    {"caption": CAPS[(i + 1) % 6]}]))
                    for i, k in enumerate(KEYS)), f"{d}/{split}.caption.tsv")
        tsv_writer(((k, "2") for k in KEYS), f"{d}/{split}.num_caption.tsv")
        tsv_writer(((k, json.dumps([{"class": "dog", "conf": 0.9}]))
                    for k in KEYS), f"{d}/{split}.label.tsv")
    enc = os.path.join(root, "tiny_encoder")
    os.makedirs(enc)
    with open(os.path.join(enc, "config.json"), "w") as f:
        json.dump({"hidden_size": 32, "num_attention_heads": 4,
                   "intermediate_size": 64, "num_hidden_layers": 2,
                   "max_position_embeddings": 96, "type_vocab_size": 2,
                   "vocab_size": 30522, "layer_norm_eps": 1e-12,
                   "attention_probs_dropout_prob": 0.0}, f)
    shutil.copy(DEFAULT_VOCAB, enc)


def _param(root, output, **kw):
    p = {
        "data": "tinycoco", "test_data": "tinycoco", "test_split": "test",
        "net": "tiny", "expid": "parity",
        "data_root": os.path.join(root, "data"),
        "output_root": os.path.join(root, output),
        "text_encoder_type": os.path.join(root, "tiny_encoder"),
        "train_crop_size": 32, "test_crop_size": 32,
        "max_seq_length": 26, "max_seq_a_length": 6, "max_gen_length": 6,
        "topk": 5, "split_blocks": 1, "decoder_layers": 2,
        "effective_batch_size": 2, "test_batch_size": 4,
        "max_iter": 3, "snapshot_steps": 2, "log_step": 1,
        "base_lr": 1e-3, "drop_out": 0.0, "num_workers": 1,
        "encode": "bert", "mesh_data": 1, "tag_loss_weight": 1.0,
        "compute_dtype": "float32",
        "basemodel": os.path.join(root, "base.pt"),
        "pipeline_type": {
            "from": "src.pipelines.tagger_caption_uni_pipeline_expanding"
                    "_bertemb",
            "import": "CaptionUniPipeline"},
    }
    p.update(kw)
    return p


@contextlib.contextmanager
def seeded(cp_module, train_step_module, step_factory, losses):
    """The pipeline module's train tensorizer and train transform get
    fixed-seed RNGs; every train step's loss is appended to `losses`."""
    with pytest.MonkeyPatch.context() as mp:
        orig = cp_module.CaptionUniPipeline.train_caption_tensorizer

        def tensorizer(self):
            t = orig(self)
            t.rng = random.Random(11)
            return t
        base = cp_module.TrainImageTransform

        class Transform(base):
            def __init__(self, *a, **kw):
                kw["seed"] = 12
                super().__init__(*a, **kw)

        make = getattr(train_step_module, step_factory)

        def recording(*a, **kw):
            fn = make(*a, **kw)

            def step(state, batch, *rest):
                state, m = fn(state, batch, *rest)
                losses.append(float(m["loss"]))
                return state, m
            return step
        mp.setattr(cp_module.CaptionUniPipeline, "train_caption_tensorizer",
                   tensorizer)
        mp.setattr(cp_module, "TrainImageTransform", Transform)
        mp.setattr(train_step_module, step_factory, recording)
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The dataset and the basemodel: the JAX package's init_params at the
    pipeline's model config, written as a reference `.pt`."""
    root = str(tmp_path_factory.mktemp("pipeline"))
    make_dataset(root)
    jcfg = JCP.CaptionUniPipeline(**_param(root, "out_jax")).model_cfg
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(3), jcfg))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                JB.params_to_torch_state_dict(params).items()},
               os.path.join(root, "base.pt"))
    return root


def _run(cp_module, ts_module, factory, run_module, param):
    losses = []
    with seeded(cp_module, ts_module, factory, losses):
        results = run_module.pipeline_train_eval_multi(TEST, param)
    return {"losses": losses, "results": results,
            "snapshot": os.path.join(param["output_root"],
                                     "tinycoco_tiny_parity", "snapshot")}


@pytest.fixture(scope="module")
def jax_run(root):
    return _run(JCP, JTS, "make_jitted_train_step", JR,
                _param(root, "out_jax"))


@pytest.fixture(scope="module")
def port_run(root):
    return _run(TCP, TTS, "make_train_step", TR,
                _param(root, "out_port", device="cpu"))


def _predict_rows(snapshot):
    (f,) = [n for n in os.listdir(snapshot) if n.endswith(".predict.tsv")]
    return [(k, json.loads(v)) for k, v in
            tsv_reader(os.path.join(snapshot, f))]


def _numbers(d, prefix=""):
    """{dotted path: number} of every numeric leaf of a report."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_numbers(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)):
            out[prefix + k] = float(v)
    return out


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def test_pipeline_losses_match_jax(jax_run, port_run):
    assert len(port_run["losses"]) == len(jax_run["losses"]) == 3
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               rtol=2e-5)


def test_pipeline_snapshots_match_jax(jax_run, port_run):
    """Snapshots at iterations 2 and 3; the final one's parameters, leaf
    by leaf, within 1e-4 of each tensor's scale."""
    for it in (2, 3):
        for run in (jax_run, port_run):
            assert os.path.isfile(os.path.join(
                run["snapshot"], f"model_iter_{it:07d}.ckpt"))
    name = "model_iter_0000003.ckpt"
    want = JB.flatten_params(jax.tree_util.tree_map(
        np.asarray, JCK.load_state(
            os.path.join(jax_run["snapshot"], name))["params"]))
    snap = torch.load(os.path.join(port_run["snapshot"], name),
                      weights_only=True)
    assert snap["iteration"] == 3 and snap["opt"]["step"] == 3
    got = TB.state_to_jax_flat(snap["model"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)


def test_pipeline_predictions_match_jax(jax_run, port_run):
    """Predict TSV: the same keys in the same order, equal captions, confs
    within rtol 1e-5 (test_batch_size 4: the second batch of 2 is padded)."""
    want, got = (_predict_rows(r["snapshot"]) for r in (jax_run, port_run))
    assert [k for k, _ in got] == [k for k, _ in want] == KEYS
    for (_, g), (_, w) in zip(got, want):
        assert [c["caption"] for c in g] == [c["caption"] for c in w]
        np.testing.assert_allclose([c["conf"] for c in g],
                                   [c["conf"] for c in w], rtol=1e-5)


def test_pipeline_report_matches_jax(jax_run, port_run):
    want, got = (_numbers(r["results"][0]) for r in (jax_run, port_run))
    for key in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"):
        assert key in got
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])


# ---------------------------------------------------------------------------
# the port's CLI and lifecycle
# ---------------------------------------------------------------------------

def test_cli_runs_a_yaml_file(root, port_run, tmp_path):
    """python -m vitcap_tpu_torch.run -c <yaml> -p <override>: the JAX
    package's pipeline module name is remapped onto the port's; a `_base_`
    file carries most keys."""
    import yaml
    param = _param(root, str(tmp_path / "out"), device="cpu", expid="cli",
                   max_iter=1, snapshot_steps=5)
    param["pipeline_type"] = {"from": "vitcap_tpu.pipelines.caption_pipeline",
                              "import": "CaptionUniPipeline"}
    (tmp_path / "base.yaml").write_text(yaml.safe_dump(
        {"type": "pipeline_eval_multi", "all_test_data": TEST,
         "param": param}))
    (tmp_path / "cli.yaml").write_text("_base_: base.yaml\n")
    results = TR.main(["-c", str(tmp_path / "cli.yaml"),
                       "-p", "type: pipeline_train_eval_multi"])
    snap = tmp_path / "out" / "tinycoco_tiny_cli" / "snapshot"
    assert (snap / "model_iter_0000001.ckpt").is_file()
    assert len(_predict_rows(str(snap))) == len(KEYS)
    assert len(results) == 1 and "CIDEr" in results[0]
    assert list(tmp_path.glob("out/tinycoco_tiny_cli/parameters_*.yaml"))
    pip = TR.load_pipeline(full_expid="tinycoco_tiny_cli",
                           folder=str(tmp_path / "out" / "tinycoco_tiny_cli"))
    assert isinstance(pip, TCP.CaptionUniPipeline) and pip.is_train_finished()


def test_cached_rerun(root, port_run):
    """A second run trains nothing and predicts nothing: the artifacts
    keep their mtimes and the results are the same."""
    param = _param(root, "out_port", device="cpu")
    snap = port_run["snapshot"]
    files = sorted(os.listdir(snap))
    mtimes = {f: os.path.getmtime(os.path.join(snap, f)) for f in files}
    losses = []
    with seeded(TCP, TTS, "make_train_step", losses):
        again = TR.pipeline_train_eval_multi(TEST, param)
    assert losses == []
    assert again == port_run["results"]
    assert sorted(os.listdir(snap)) == files
    assert {f: os.path.getmtime(os.path.join(snap, f))
            for f in files} == mtimes
    assert TR.pipeline_eval_multi(TEST, param) == port_run["results"]


def test_resume_from_iteration_2_snapshot(root, port_run, tmp_path):
    """With the iteration-2 snapshot and its pointer in place, a run trains
    only iteration 3, from the snapshot's moments and step."""
    param = _param(root, str(tmp_path), device="cpu")
    snap = tmp_path / "tinycoco_tiny_parity" / "snapshot"
    snap.mkdir(parents=True)
    shutil.copy(os.path.join(port_run["snapshot"],
                             "model_iter_0000002.ckpt"), snap)
    (snap / "last_checkpoint").write_text(
        str(snap / "model_iter_0000002.ckpt"))
    losses = []
    with seeded(TCP, TTS, "make_train_step", losses):
        TR.create_pipeline(param).ensure_train()
    assert len(losses) == 1 and np.isfinite(losses[0])
    final = torch.load(snap / "model_iter_0000003.ckpt", weights_only=True)
    assert final["iteration"] == 3 and final["opt"]["step"] == 3


def test_sigterm_snapshots_and_resumes(root, tmp_path, monkeypatch):
    """SIGTERM during training: a snapshot at the next step boundary and
    SystemExit(143); a fresh pipeline resumes from it and finishes."""
    import signal
    param = _param(root, str(tmp_path), device="cpu", expid="preempt",
                   max_iter=5, snapshot_steps=100)
    pip = TR.create_pipeline(param)
    orig = pip._device_train_batch
    calls = []

    def tripwire(batch):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(batch)
    monkeypatch.setattr(pip, "_device_train_batch", tripwire)
    with pytest.raises(SystemExit) as e:
        pip.ensure_train()
    assert e.value.code == 143
    snap = tmp_path / "tinycoco_tiny_preempt" / "snapshot"
    assert sorted(p.name for p in snap.glob("model_iter_*.ckpt")) == [
        "model_iter_0000002.ckpt"]
    TR.create_pipeline(param).ensure_train()
    final = torch.load(snap / "model_iter_0000005.ckpt", weights_only=True)
    assert final["opt"]["step"] == 5


def test_nan_loss_writes_a_tagged_snapshot(root, tmp_path, monkeypatch):
    """A non-finite loss at a log step: NaN_context_0.ckpt, the pointer
    left at the last healthy snapshot, RuntimeError."""
    param = _param(root, str(tmp_path), device="cpu", expid="nan",
                   max_iter=3, snapshot_steps=1)
    make = TTS.make_train_step

    def poisoned(*a, **kw):
        fn = make(*a, **kw)

        def step(state, batch, *rest):
            state, m = fn(state, batch, *rest)
            if state.opt.step == 2:
                m = dict(m, loss=torch.tensor(float("nan")))
            return state, m
        return step
    monkeypatch.setattr(TTS, "make_train_step", poisoned)
    with pytest.raises(RuntimeError, match="NaN loss at iter 2"):
        TR.create_pipeline(param).ensure_train()
    snap = tmp_path / "tinycoco_tiny_nan" / "snapshot"
    assert (snap / "NaN_context_0.ckpt").is_file()
    assert (snap / "last_checkpoint").read_text().endswith(
        "model_iter_0000001.ckpt")


def test_predict_from_a_released_pt(root, port_run, tmp_path):
    """A reference-named `.pt` dropped into a fresh experiment's snapshot
    folder as model_iter_*.pt is found by get_checkpoint_file, loads
    through the bridge and predicts the native snapshot's captions."""
    param = _param(root, str(tmp_path), device="cpu", expid="released")
    pip = TR.create_pipeline(dict(param, **TEST[0]))
    assert not pip.is_train_finished()
    os.makedirs(pip.model_folder)
    snap = torch.load(os.path.join(port_run["snapshot"],
                                   "model_iter_0000003.ckpt"),
                      weights_only=True)
    pt = os.path.join(pip.model_folder, "model_iter_0000003.pt")
    torch.save({"model": {f"module.{k}": v
                          for k, v in snap["model"].items()}}, pt)
    assert pip.get_checkpoint_file() == pt and pip.is_train_finished()
    results = TR.pipeline_eval_multi(TEST, param)
    assert results and "CIDEr" in results[0]
    assert _predict_rows(pip.model_folder) == \
        _predict_rows(port_run["snapshot"])


def test_scst_two_steps_write_snapshot(root, port_run, tmp_path):
    """SCST from the XE run's final snapshot: 2 steps, a finite loss, the
    final snapshot (the sampled ids are not compared with JAX's: F3)."""
    base = os.path.join(port_run["snapshot"], "model_iter_0000003.ckpt")
    param = _param(root, str(tmp_path), device="cpu", expid="scst",
                   scst=True, scst_num_return=2, max_iter=2,
                   snapshot_steps=10, cider_cached_tokens="corpus",
                   base_lr=1e-4, basemodel=base)
    pip = TR.create_pipeline(param)
    pip.ensure_train()
    out = tmp_path / "tinycoco_tiny_scst" / "snapshot"
    snap = torch.load(out / "model_iter_0000002.ckpt", weights_only=True)
    assert snap["opt"]["step"] == 2
    assert pip.train_meters.scst_loss.count == 2
    assert np.isfinite(pip.train_meters.scst_loss.global_avg)


@pytest.mark.parametrize("kw, err, words", [
    ({"loader": "grain"}, NotImplementedError, "Grain"),
    ({"mesh_data": 2}, ValueError, "nproc_per_node 2"),
    ({"checkpoint_backend": "msgpack"}, ValueError, "one backend"),
    ({"checkpoint_backend": "orbax"}, ValueError, "one backend"),
    ({"async_checkpoint": True}, ValueError, "synchronously"),
    ({"jax_profile_dir": "trace"}, NotImplementedError, "profiler"),
    ({"image_encoder_type": "VitEmb_hrnet_w18"}, ValueError,
     "no ViT trunk"),
    ({"image_encoder_type": "VitEmb_efficientnet_b0"}, ValueError,
     "no ViT trunk"),
], ids=["grain", "mesh_data", "msgpack", "orbax", "async",
        "jax_profile_dir", "zoo_trunk", "zoo_cnn_trunk"])
def test_unported_keys_raise(root, tmp_path, kw, err, words):
    param = _param(root, str(tmp_path), device="cpu", **kw)
    with pytest.raises(err, match=words):
        pip = TR.create_pipeline(param)
        pip.model_cfg


def test_more_than_one_rank_raises(root, tmp_path, monkeypatch):
    """Two ranks under a YAML whose mesh_data says one: mesh_data must be
    the number of processes (one a device)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="mesh_data: 1 with 2"):
        TR.create_pipeline(_param(root, str(tmp_path), device="cpu"))


def test_cuda_without_a_card_raises(root, tmp_path, monkeypatch):
    """The default device is the card; a host without one raises, nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pip = TR.create_pipeline(_param(root, str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pip.ensure_train()
