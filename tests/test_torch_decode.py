"""vitcap_tpu_torch decode options, beam search and the fused decode step
vs the JAX package, on the CPU.

The same weights (the JAX param tree, loaded through load_jax_params) and
the same numpy inputs go through both packages at tiny_config.  Each engine
of the port is held against the same engine of the JAX package, selected
the same way: VITCAP_DECODE_FUSED=0 (eager, 'heads' layout) or
=interpret (the fused step over the 'flat' layout: on the JAX side its
Pallas kernel in interpret mode, on the port's side fused_decode_step's
plain version, which the CPU runs).  Sampling draws from different
generators in the two packages, so sampled decodes are compared in their
deterministic limit and statistically.
"""

import ast
import logging
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import decode as JD
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.ops import decode_step as JDS
from vitcap_tpu.solver import checkpoint_bridge as JB

from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import decode as TD
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.ops import decode_step as TDS
from vitcap_tpu_torch.serving import CaptionServer
from vitcap_tpu_torch.solver import checkpoint_bridge as TB

ROOT = Path(__file__).resolve().parents[1]
B = 4
ENGINES = {"heads": "0", "flat": "interpret"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _models(lm_bias_scale=0.0):
    """tiny_config weights as a JAX param tree and a port ViTCAP.  A
    nonzero lm_bias_scale gives the LM head a N(0, scale) bias, which
    spreads the logits (the random init leaves them nearly flat)."""
    jcfg = jax_tiny_config()
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    if lm_bias_scale:
        rs = np.random.RandomState(4)
        params["cls"]["decoder"]["bias"] = (
            rs.randn(jcfg.vocab_size) * lm_bias_scale).astype(np.float32)
    model = TB.load_jax_params(TM.ViTCAP(TC.tiny_config()), params)
    return (jcfg, TC.tiny_config(),
            jax.tree_util.tree_map(jnp.asarray, params), model)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg, params, model = _models()
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3)) \
        .astype(np.uint8)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    od = rs.randint(1, cfg.vocab_size, (B, od_len)).astype(np.int32)
    # a different od validity per image
    sl = np.array([cfg.max_seq_a_len + (i * 3) % (od_len + 1)
                   for i in range(B)], np.int32)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, imgs=imgs,
                od=od, sl=sl)


def _opts(cfg, **kw):
    base = dict(max_length=cfg.max_seq_a_len,
                od_labels_start_posid=cfg.max_seq_a_len)
    base.update(kw)
    return JD.DecodeOptions(**base), TD.DecodeOptions(**base)


def _run_both(s, monkeypatch, engine, kw, jcfg=None, cfg=None, params=None,
              model=None, rng_j=None, rng_t=None):
    """generate through both packages under one engine selection."""
    monkeypatch.setenv("VITCAP_DECODE_FUSED", ENGINES[engine])
    jo, to = _opts(s["cfg"], **kw)
    ref = JD.generate(params if params is not None else s["params"],
                      jnp.asarray(s["imgs"]), jnp.asarray(s["od"]), None,
                      jnp.asarray(s["sl"]), jcfg or s["jcfg"], jo, rng=rng_j)
    out = TD.generate(model if model is not None else s["model"],
                      torch.from_numpy(s["imgs"]),
                      torch.from_numpy(s["od"]).long(), None,
                      torch.from_numpy(s["sl"]).long(), cfg or s["cfg"], to,
                      rng=rng_t)
    return ref, out


def _assert_same(ref, out, rtol=1e-4, atol=1e-5):
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    np.testing.assert_allclose(out["logprobs"].numpy(),
                               np.asarray(ref["logprobs"]), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the fused step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_step_matches_jax(setup, dtype):
    """One step of every layer: the port's fused_decode_step (the plain
    version on the CPU) vs the JAX Pallas kernel in interpret mode, nb=3
    beams per image, a context length off every tile size, history in
    the caption caches, a different od validity per image."""
    s = setup
    cfg = s["cfg"]
    H, nL, nh = cfg.hidden_size, cfg.decoder_layers, cfg.num_attention_heads
    nb, S, A, t = 3, 13, 6, 3
    Bb = B * nb
    rs = np.random.RandomState(1)
    x = rs.randn(Bb, 2, H).astype(np.float32)
    ck = [rs.randn(B, S, H).astype(np.float32) for _ in range(nL)]
    cv = [rs.randn(B, S, H).astype(np.float32) for _ in range(nL)]
    valid = rs.rand(B, S) > 0.3
    valid[:, -1] = True
    cap_k = rs.randn(nL, Bb, A, H).astype(np.float32)
    cap_v = rs.randn(nL, Bb, A, H).astype(np.float32)

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    kp, vp, cb = JDS.pack_decode_context(
        [jnp.asarray(a, jdt) for a in ck], [jnp.asarray(a, jdt) for a in cv],
        jnp.asarray(valid))
    rx, rk, rv = JDS.fused_decode_step(
        JDS.pack_decode_layers(s["params"], jdt), kp, vp, cb,
        jnp.asarray(cap_k, jdt), jnp.asarray(cap_v, jdt),
        jnp.asarray(x, jdt), jnp.int32(t), num_heads=nh,
        eps=cfg.bert_layer_norm_eps, interpret=True)

    def tt(a):
        return torch.from_numpy(a).to(tdt)
    k, v, bias = TDS.pack_decode_context([tt(a) for a in ck],
                                         [tt(a) for a in cv],
                                         torch.from_numpy(valid))
    tk, tv = tt(cap_k), tt(cap_v)
    out = TDS.fused_decode_step(
        TDS.pack_decode_layers(s["model"], tdt), k, v, bias, tk, tv, tt(x),
        torch.tensor(t, dtype=torch.int32), num_heads=nh,
        eps=cfg.bert_layer_norm_eps)
    for name, got, ref in (("x", out, rx), ("cap_k", tk, rk),
                           ("cap_v", tv, rv)):
        got = got.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                       err_msg=name)
        else:
            scale = np.abs(ref).max()
            err = np.abs(got - ref).max()
            same = float((got == ref).mean())
            print(f"bf16 fused step {name}: max err {err:.3g} of scale "
                  f"{scale:.3g}, {same:.4f} of elements bit-equal")
            assert err <= 2e-2 * scale, (name, err, scale)


def test_decode_attention_plain_skips_future_slots(setup):
    """Caption slots at and past t are neither read nor written (the
    kernel stops there), the prev slot t-1 is written, and only the MASK
    row sees its own key: the prev row's output ignores the MASK k/v."""
    rs = np.random.RandomState(2)
    Bb, H, nh, A, S, t = 2, 16, 2, 5, 7, 2
    qkv = torch.from_numpy(rs.randn(Bb, 2, 3 * H).astype(np.float32))
    ck = torch.from_numpy(rs.randn(1, S, H).astype(np.float32))
    cv = torch.from_numpy(rs.randn(1, S, H).astype(np.float32))
    bias = torch.zeros(1, S)
    caps = [torch.from_numpy(rs.randn(Bb, A, H).astype(np.float32))
            for _ in range(2)]
    before = [c.clone() for c in caps]
    out = TDS.decode_attention(qkv, *caps, ck, cv, bias,
                               torch.tensor(t, dtype=torch.int32), nh)
    for c, c0, part in zip(caps, before, (1, 2)):
        torch.testing.assert_close(c[:, t - 1], qkv[:, 0, part * H:
                                                    (part + 1) * H])
        assert torch.equal(c[:, t:], c0[:, t:])
        assert torch.equal(c[:, :t - 1], c0[:, :t - 1])
    caps2 = [c0.clone() for c0 in before]
    for c in caps2:
        c[:, t:] = 1e3                         # future slots: garbage
    qkv2 = qkv.clone()
    qkv2[:, 1, H:] = -7.0                      # the MASK row's own k/v
    out2 = TDS.decode_attention(qkv2, *caps2, ck, cv, bias,
                                torch.tensor(t, dtype=torch.int32), nh)
    torch.testing.assert_close(out2[:, 0], out[:, 0], rtol=0, atol=0)
    assert not torch.allclose(out2[:, 1], out[:, 1])


# ---------------------------------------------------------------------------
# greedy, beam and the decode options, both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["heads", "flat"])
@pytest.mark.parametrize("kw", [dict(), dict(num_beams=3, num_keep_best=2)],
                         ids=["greedy", "beam3"])
def test_generate_matches_jax(setup, monkeypatch, engine, kw):
    """Greedy and beam-3 (two kept hypotheses), B=4 with a different
    seq_len per image: ids exact, logprobs at rtol 1e-4 / atol 1e-5."""
    ref, out = _run_both(setup, monkeypatch, engine, kw)
    _assert_same(ref, out)
    if not kw:
        np.testing.assert_allclose(out["step_scores"].numpy(),
                                   np.asarray(ref["step_scores"]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("engine", ["heads", "flat"])
@pytest.mark.parametrize("kw", [dict(repetition_penalty=1.7),
                                dict(num_beams=3, repetition_penalty=2.0)],
                         ids=["greedy", "beam3"])
def test_repetition_penalty_matches_jax(setup, monkeypatch, engine, kw):
    ref, out = _run_both(setup, monkeypatch, engine, kw)
    _assert_same(ref, out)


@pytest.mark.parametrize("engine", ["heads", "flat"])
def test_beam_sample_low_temperature_matches_jax(setup, monkeypatch,
                                                 engine):
    """Sampled beam search at temperature 0.003: both draws per beam
    collapse to that beam's top-2, so the decode (with the reference's
    tiled beam offsets) is the same whatever the random stream.  The LM
    head gets a spread bias so that every step's top-3 gaps are wide; two
    seeds per package show the limit is reached."""
    jcfg, cfg, params, model = _models(lm_bias_scale=3.0)
    kw = dict(num_beams=3, do_sample=True, temperature=0.003)
    outs = []
    for seed in (0, 1):
        ref, out = _run_both(setup, monkeypatch, engine, kw, jcfg, cfg,
                             params, model, rng_j=jax.random.PRNGKey(seed),
                             rng_t=torch.Generator().manual_seed(seed))
        _assert_same(ref, out, rtol=1e-2, atol=1e-3)
        outs.append(out["ids"])
    assert torch.equal(outs[0], outs[1])


def test_top_k_top_p_filtering_matches_jax():
    rs = np.random.RandomState(3)
    logits = rs.randn(6, 50).astype(np.float32) * 2
    for top_k, top_p, keep in ((0, 1.0, 1), (5, 1.0, 1), (0, 0.7, 1),
                               (10, 0.5, 2), (1, 0.01, 2)):
        ref = JD.top_k_top_p_filtering(jnp.asarray(logits), top_k, top_p,
                                       min_tokens_to_keep=keep)
        out = TD.top_k_top_p_filtering(torch.from_numpy(logits), top_k,
                                       top_p, min_tokens_to_keep=keep)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref),
                                      err_msg=f"{top_k} {top_p} {keep}")


def test_sample_beam_candidates_distribution():
    """(a) each beam's first draw is categorical(softmax(logits)) within
    5 sigma; (b) the two draws of a beam differ (without replacement);
    (c) the beam offsets are tiled as in the reference; scores are the
    beam's log-softmax at the word."""
    nb, V, N = 2, 7, 4000
    rs = np.random.RandomState(5)
    logits = torch.from_numpy(rs.randn(nb, V).astype(np.float32))
    opts = TD.DecodeOptions(do_sample=True, num_beams=nb)
    # N independent images with the same two beam rows
    scores, idxs = TD.sample_beam_candidates(
        logits.repeat(N, 1), torch.zeros(N, nb), torch.Generator()
        .manual_seed(0), nb, opts)
    idxs, scores = idxs.numpy(), scores.numpy()     # slots b0d0 b0d1 b1d0 b1d1
    words = np.stack([idxs[:, 0], idxs[:, 1] - V, idxs[:, 2],
                      idxs[:, 3] - V], axis=1)
    assert words.min() >= 0 and words.max() < V
    assert (words[:, 0] != words[:, 1]).all()
    assert (words[:, 2] != words[:, 3]).all()
    for beam, slot in ((0, 0), (1, 2)):
        p = torch.softmax(logits[beam], -1).numpy()
        freq = np.bincount(words[:, slot], minlength=V) / N
        sigma = np.sqrt(p * (1 - p) / N)
        np.testing.assert_array_less(np.abs(freq - p), 5 * sigma + 1e-9)
    lp0 = torch.log_softmax(logits[0], -1).numpy()
    np.testing.assert_allclose(scores[:, 0], lp0[words[:, 0]], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("engine", ["heads", "flat"])
def test_num_return_sequences_shapes(setup, monkeypatch, engine):
    """Sampled greedy with 3 return sequences, and beam search keeping 2:
    the shapes of the JAX package, every row a caption that starts with
    CLS and carries one SEP."""
    s = setup
    A = s["cfg"].max_seq_a_len
    for kw, shape in ((dict(do_sample=True, num_return_sequences=3,
                            top_k=20), (B, 3, A)),
                      (dict(num_beams=3, num_keep_best=2), (B, 2, A))):
        ref, out = _run_both(s, monkeypatch, engine, kw)
        assert tuple(out["ids"].shape) == np.asarray(ref["ids"]).shape \
            == shape
        assert tuple(out["logprobs"].shape) == shape[:2]
        ids = out["ids"].numpy()
        assert (ids[..., 0] == s["cfg"].cls_token_id).all()
        assert ((ids == s["cfg"].sep_token_id).sum(-1) == 1).all()
        assert np.isfinite(out["logprobs"].numpy()).all()
    assert tuple(out["tag_logits"].shape) == (B, s["cfg"].tag_vocab_size)


@pytest.mark.parametrize("engine", ["heads", "flat"])
def test_int8_cache_matches_jax_int8(setup, monkeypatch, engine, caplog):
    """kv_cache_quant='int8': greedy and beam ids exact vs the JAX
    package's int8 path; under the fused selection both packages keep the
    eager engine and say so."""
    s = setup
    jcfg = s["jcfg"].replace(kv_cache_quant="int8")
    cfg = s["cfg"].replace(kv_cache_quant="int8")
    with caplog.at_level(logging.WARNING):
        for kw in (dict(), dict(num_beams=3, num_keep_best=2)):
            ref, out = _run_both(s, monkeypatch, engine, kw, jcfg, cfg)
            _assert_same(ref, out)
    assert (engine == "flat") == ("kv_cache_quant=int8" in caplog.text)


def test_caption_server_with_beams(setup, monkeypatch):
    """Beam-3 keeping 2, fused engine, batch 2 over 3 requests from client
    threads: each future resolves with row 0 of its image's direct
    generate result."""
    s = setup
    cfg = s["cfg"]
    monkeypatch.setenv("VITCAP_DECODE_FUSED", "1")
    _, opts = _opts(cfg, num_beams=3, num_keep_best=2,
                    max_length=cfg.max_gen_length)
    images = s["imgs"][:3]
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    direct = TD.generate(s["model"], torch.from_numpy(images),
                         torch.zeros(3, od_len, dtype=torch.long), None,
                         torch.full((3,), cfg.max_seq_a_len), cfg, opts)
    with CaptionServer(s["model"], cfg, opts, batch_size=2,
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
        assert not any(t.is_alive() for t in threads)
        results = [f.result(timeout=120) for f in futs]
    for i, got in enumerate(results):
        np.testing.assert_array_equal(got["ids"],
                                      direct["ids"][i, 0].numpy())
        assert got["logprob"] == pytest.approx(
            float(direct["logprobs"][i, 0]), rel=1e-5)


def test_caption_server_samples_on_its_device(setup):
    """A sampling server draws from a generator on the serving device."""
    s = setup
    _, opts = _opts(s["cfg"], do_sample=True, top_k=5,
                    max_length=s["cfg"].max_gen_length)
    with CaptionServer(s["model"], s["cfg"], opts, batch_size=2,
                       seed=3) as server:
        out = server.caption(s["imgs"][0], timeout=120)
        assert server._generator.device == server.device
    assert out["ids"][0] == s["cfg"].cls_token_id
    assert np.isfinite(out["logprob"])


# ---------------------------------------------------------------------------
# the port imports nothing of JAX; its copy of the checkpoint bridge
# ---------------------------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "vitcap_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return (top in ("jax", "jaxlib", "flax", "orbax", "optax", "grain")
            or top == "vitcap_tpu")


def test_port_sources_import_no_jax():
    """Every module of vitcap_tpu_torch, and chip_smoke.py, parsed with
    ast: no `import jax`, `from jax...`, no flax, orbax, optax or grain
    (JAX-ecosystem packages), no `import vitcap_tpu` or
    `from vitcap_tpu...`, at any depth (vitcap_tpu_torch itself is
    allowed)."""
    files = _port_sources()
    assert len(files) >= 55
    for new in ("solver/checkpointing.py", "solver/scst.py",
                "evals/metrics.py", "ops/flash_attention.py",
                "utils/common.py", "utils/meters.py", "data/tsv.py",
                "data/tokenization.py", "data/transforms.py",
                "data/tensorizers.py", "data/dataset.py", "evals/ptb.py",
                "evals/meteor.py", "evals/spice.py", "evals/coco_eval.py",
                "evals/nocaps.py", "pipelines/uni_pipeline.py",
                "pipelines/caption_pipeline.py", "run.py", "models/cbs.py",
                "parallel/distributed.py", "parallel/mesh.py",
                "models/pretrained.py", "models/scan.py",
                "models/registry.py", "models/backbones.py",
                "models/t2t_vit.py", "models/pruned.py",
                "models/efficientnet.py", "models/mobilenetv3.py",
                "models/mixnet.py", "models/rexnet.py", "models/regnet.py",
                "models/nfnet.py", "models/resnetv2.py"):
        assert ROOT / "vitcap_tpu_torch" / new in files
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _banned(n)]
    assert not bad, bad
    assert not _banned("vitcap_tpu_torch.ops")
    assert _banned("orbax.checkpoint") and _banned("flax.serialization")
    assert _banned("grain.python")


def test_checkpoint_bridge_copy_matches_jax_bridge():
    """The port's numpy copy of the bridge gives the JAX package's
    state dict: the same names, layouts and values."""
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(1), jax_tiny_config()))
    ref = JB.params_to_torch_state_dict(params)
    out = TB.params_to_torch_state_dict(params)
    assert list(out) == list(ref)
    for name in ref:
        assert out[name].shape == ref[name].shape, name
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    flat = TB.flatten_params(params)
    assert flat.keys() == JB.flatten_params(params).keys()
    for path in flat:
        assert TB.jax_path_to_torch_name(path) == \
            JB.jax_path_to_torch_name(path), path


def test_init_params_defaults_to_the_card():
    """init_params builds on the card unless the caller asks for another
    device: without one the default fails rather than landing on the CPU."""
    cfg = TC.tiny_config()
    if torch.cuda.is_available():
        m = TM.init_params(cfg, torch.Generator().manual_seed(0))
        assert next(m.parameters()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            TM.init_params(cfg, torch.Generator().manual_seed(0))
    m = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert next(m.parameters()).device.type == "cpu"
