"""vitcap_tpu_torch greedy captioning slice vs the JAX package, on the CPU.

The same weights (the JAX param tree, loaded through load_jax_params) and
the same numpy inputs go through both packages.  The JAX side runs with
VITCAP_PALLAS=interpret, so its fused split-block kernels run (in interpret
mode) exactly where the port's fused blocks run.  At tiny_config(img_size=
128) the trunk has 65 tokens, so both fused paths engage.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.data.tokenization import BertTokenizer
from vitcap_tpu.models import decode as JD
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import ModelConfig as JaxModelConfig
from vitcap_tpu.models.config import tiny_config as jax_tiny_config

from vitcap_tpu_torch.data.tokenization import DEFAULT_VOCAB, CaptionDecoder
from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import decode as TD
from vitcap_tpu_torch.models import layers as TL
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.serving import CaptionServer
from vitcap_tpu_torch.solver.checkpoint_bridge import load_jax_params

KW = dict(img_size=128)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny_config(**KW)
    cfg = TC.tiny_config(**KW)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(TM.ViTCAP(cfg),
                            jax.tree_util.tree_map(np.asarray, params))
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3)) \
        .astype(np.uint8)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    od = rs.randint(1, cfg.vocab_size, (B, od_len)).astype(np.int32)
    sl = np.array([cfg.max_seq_a_len + 2, cfg.max_seq_a_len + od_len],
                  np.int32)
    opts_j = JD.DecodeOptions(max_length=cfg.max_gen_length,
                              od_labels_start_posid=cfg.max_seq_a_len)
    opts_t = TD.DecodeOptions(max_length=cfg.max_gen_length,
                              od_labels_start_posid=cfg.max_seq_a_len)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, imgs=imgs,
                od=od, sl=sl, opts_j=opts_j, opts_t=opts_t)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("VITCAP_PALLAS", "interpret")


def _torch_inputs(s):
    return (torch.from_numpy(s["imgs"]), torch.from_numpy(s["od"]).long(),
            torch.from_numpy(s["sl"]).long())


def test_encode_images_matches_jax(setup, interpret):
    s = setup
    from vitcap_tpu.ops import inference_mode
    with inference_mode():
        ref = JM.encode_images(s["params"], jnp.asarray(s["imgs"]),
                               s["jcfg"])
    out = TM.encode_images(s["model"], torch.from_numpy(s["imgs"]), s["cfg"])
    for key in ("visual", "tag_cls", "tag_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(out["pred_topk"].numpy(),
                                  np.asarray(ref["pred_topk"]))


def test_build_decode_context_matches_jax(setup, interpret):
    s = setup
    ref = JD.build_decode_context(s["params"], jnp.asarray(s["imgs"]),
                                  jnp.asarray(s["od"]), None,
                                  jnp.asarray(s["sl"]), s["jcfg"],
                                  s["opts_j"], layout="heads")
    imgs, od, sl = _torch_inputs(s)
    out = TD.build_decode_context(s["model"], imgs, od, None, sl, s["cfg"],
                                  s["opts_t"])
    np.testing.assert_array_equal(out["ctx_valid"].numpy(),
                                  np.asarray(ref["ctx_valid"]))
    for li in range(s["cfg"].decoder_layers):
        for key in ("ctx_k", "ctx_v"):
            np.testing.assert_allclose(out[key][li].numpy(),
                                       np.asarray(ref[key][li]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{key}[{li}]")


def test_generate_greedy_matches_jax(setup, interpret):
    """The whole slice: ids exact, logprobs at the decode-parity tolerance
    of the JAX package's own tests."""
    s = setup
    ref = JD.generate(s["params"], jnp.asarray(s["imgs"]),
                      jnp.asarray(s["od"]), None, jnp.asarray(s["sl"]),
                      s["jcfg"], s["opts_j"])
    imgs, od, sl = _torch_inputs(s)
    out = TD.generate(s["model"], imgs, od, None, sl, s["cfg"], s["opts_t"])
    np.testing.assert_allclose(out["tag_logits"].numpy(),
                               np.asarray(ref["tag_logits"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(out["pred_topk"].numpy(),
                                  np.asarray(ref["pred_topk"]))
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    np.testing.assert_allclose(out["logprobs"].numpy(),
                               np.asarray(ref["logprobs"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out["step_scores"].numpy(),
                               np.asarray(ref["step_scores"]), rtol=1e-4,
                               atol=1e-5)


def test_generate_refuses_unported_options(setup):
    """Every DecodeOptions field is ported (tests/test_torch_decode.py);
    what generate still refuses: images whose patch count is not a square
    (the pos-embed grid cannot be resized to it), and a kv_cache_quant
    other than 'none' / 'int8'."""
    s = setup
    imgs, od, sl = _torch_inputs(s)
    with pytest.raises(ValueError, match="square"):
        TD.generate(s["model"], imgs[:, :, :96].contiguous(), od, None, sl,
                    s["cfg"], s["opts_t"])
    with pytest.raises(ValueError):
        TD.generate(s["model"], imgs, od, None, sl,
                    s["cfg"].replace(kv_cache_quant="fp8"), s["opts_t"])


def test_patch_embed_layouts_agree(setup):
    """uint8 NHWC, float NHWC with conv truncation, and host-patchified
    input give the same tokens."""
    s = setup
    proj = s["model"].image_encoder.module.patch_embed.proj
    img = s["imgs"][:1]
    u8 = TL.patch_embed(proj, torch.from_numpy(img))
    norm = (img.astype(np.float32) / 255.0 - 0.5) / 0.5
    pad = np.pad(norm, ((0, 0), (0, 7), (0, 5), (0, 0)))   # sub-patch tail
    f32 = TL.patch_embed(proj, torch.from_numpy(pad))
    pre = TL.patch_embed(proj, torch.from_numpy(
        TL.patchify_host(norm[0], s["cfg"].patch_size)[None]))
    np.testing.assert_allclose(u8.numpy(), f32.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pre.numpy(), f32.numpy(), rtol=1e-5, atol=1e-5)


def test_init_params_rule():
    cfg = TC.tiny_config()
    m1 = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    m2 = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sd1, sd2 = m1.state_dict(), m2.state_dict()
    for name, t in sd1.items():
        assert torch.equal(t, sd2[name]), name
        if name.endswith("bias"):
            assert not t.any(), name
        elif "LayerNorm" in name or "norm" in name:
            assert torch.all(t == 1), name
        else:
            assert t.abs().max() <= 0.04 and t.std() > 0.01, name
    jparams = JM.init_params(jax.random.PRNGKey(0), jax_tiny_config())
    from vitcap_tpu.solver.checkpoint_bridge import params_to_torch_state_dict
    names = {k.removeprefix("module.") for k in params_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, jparams))}
    assert set(sd1) == names


def test_caption_decoder_matches_jax_tokenizer():
    ref = BertTokenizer(str(DEFAULT_VOCAB))
    dec = CaptionDecoder()
    ids = ref.encode("a man riding a snowboard down a snow-covered slope")
    ids = [101] + ids + [102, 0, 0]
    assert dec.decode(ids) == ref.decode(ids)
    assert dec.decode(ids, skip_special_tokens=False) == \
        ref.decode(ids, skip_special_tokens=False)


def test_caption_server_answers_requests(setup):
    """Several client threads, batch 2 over 3 requests (full batch + padded
    tail): each future equals the direct generate ids for its image."""
    s = setup
    cfg = s["cfg"]
    imgs, od, sl = _torch_inputs(s)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    images = np.concatenate([s["imgs"], s["imgs"][:1]])
    direct = TD.generate(s["model"], torch.from_numpy(images),
                         torch.zeros(3, od_len, dtype=torch.long), None,
                         torch.full((3,), cfg.max_seq_a_len), cfg,
                         s["opts_t"])["ids"][:, 0].numpy()
    with CaptionServer(s["model"], cfg, batch_size=2,
                       max_delay_s=0.05) as server:
        futs = [None] * 3

        def client(i):
            futs[i] = server.submit(images[i])
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        results = [f.result(timeout=120) for f in futs]
        stats = server.stats()
    for got, want in zip(results, direct):
        np.testing.assert_array_equal(got["ids"], want)
    assert stats["requests"] == 3 and stats["batches"] >= 2

    with CaptionServer(s["model"], cfg, tokenizer=CaptionDecoder(),
                       batch_size=2) as server:
        out = server.caption(images[0], timeout=120)
        with pytest.raises(ValueError):
            server.submit(np.zeros((3, 3)))
    assert isinstance(out["caption"], str) and 0 < out["conf"] <= 1.0
    with pytest.raises(RuntimeError):
        server.submit(images[0])


def test_port_config_mirrors_jax_config():
    jf = {f.name: f.default for f in dataclasses.fields(JaxModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TC.ModelConfig)}
    assert jf == tf
    assert TC.ModelConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    assert TC.ModelConfig().attention_scores_dtype is None
    assert dataclasses.asdict(TC.tiny_config()) == \
        dataclasses.asdict(jax_tiny_config())


def test_port_imports_no_jax():
    """Importing every vitcap_tpu_torch module leaves jax out of
    sys.modules (run in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vitcap_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'vitcap_tpu' or m.startswith('vitcap_tpu.')]\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
