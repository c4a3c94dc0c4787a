"""vitcap_tpu_torch training path vs the JAX package, on the CPU.

forward_train (loss, its parts, logits and every gradient), forward_score,
the schedules, param groups, clip and AdamW step, and two whole train
steps, each held to the JAX package on the same weights (load_jax_params)
and numpy inputs.  The JAX side runs with VITCAP_TRAIN_PALLAS=interpret, so
its train blocks (split_vit_block_train, split_bert_layer_train and the
packed attention kernels) run where the port's do.  At tiny_config(
img_size=128) the trunk has 65 -> 80 tokens and the decoder 82 -> 96, so
every train route engages.  Gradients come back through the port's
reverse bridge (checkpoint_bridge.state_to_jax_flat).  train_fused_blocks
is held to the JAX package's with VITCAP_PALLAS=interpret too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.solver import optimization as JO
from vitcap_tpu.solver import train_step as JT

from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.solver import checkpoint_bridge as TB
from vitcap_tpu_torch.solver import optimization as TO
from vitcap_tpu_torch.solver import train_step as TT

B = 2
KW = dict(img_size=128, tag_loss_weight=1.0)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("VITCAP_TRAIN_PALLAS", "interpret")


def _setup(**kw):
    kw = dict(KW, **kw)
    jcfg, cfg = jax_tiny_config(**kw), TC.tiny_config(**kw)
    params = jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(21)
    for path, a in TB.flatten_params(params).items():
        if path.endswith("bias"):         # non-zero, so they are tested
            a[...] = rs.randn(*a.shape).astype(np.float32) * 0.02
    model = TB.load_jax_params(TM.ViTCAP(cfg), params).requires_grad_(True)
    T, A = cfg.max_seq_len, cfg.max_seq_a_len
    masked_pos = np.zeros((B, T), np.int32)
    masked_pos[0, [1, 2, 4]] = 1
    masked_pos[1, [3, 5]] = 1
    label = (rs.rand(B, cfg.tag_vocab_size) < 0.05).astype(np.float32)
    label[:, 7] = 1.0
    batch = {
        "image": rs.randn(B, cfg.img_size, cfg.img_size, 3)
                 .astype(np.float32),
        "input_ids": rs.randint(1, cfg.vocab_size, (B, T)).astype(np.int32),
        "token_type_ids": np.concatenate(
            [np.zeros((B, A), np.int32), np.ones((B, T - A), np.int32)], 1),
        "seq_a_len": np.array([A, A - 2], np.int32),
        "seq_len": np.array([T, T - 4], np.int32),
        "masked_pos": masked_pos,
        "masked_ids": rs.randint(1, cfg.vocab_size,
                                 (B, cfg.max_masked_tokens)).astype(np.int32),
        "label": label,
    }
    batch["masked_ids"][1, 2] = 0               # a padding slot
    return jcfg, cfg, params, model, batch


def _torch_batch(batch):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t.long() if t.dtype == torch.int32 else t
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_layer_seeds(rng, n):
    """The seeds JAX's fusion decoder derives for its split layers:
    r_emb, r_dec = split(rng); layer li draws bits(fold_in(r_dec, li), 2)
    (vitcap_tpu/models/layers.py:544-545)."""
    _, r_dec = jax.random.split(rng)
    return [np.asarray(jax.lax.bitcast_convert_type(
        jax.random.bits(jax.random.fold_in(r_dec, li), (2,), jnp.uint32),
        jnp.int32)).tolist() for li in range(n)]


def _grads_np(model):
    return TB.state_to_jax_flat(
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in model.named_parameters()})


# ---------------------------------------------------------------------------
# forward_train and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_dropout", [0.0, 0.1])
def test_forward_train_and_grads_match_jax(interpret, attn_dropout):
    """Loss, its parts, the logits and every gradient, leaf by leaf.  At
    attention dropout 0.1 the port gets the seeds JAX derives from its key,
    so the masks are the same bits.  f32 tolerances: values 2e-5 (the
    blocks' own), gradients 1e-4 of each leaf's scale (sums over 4 + 2
    analytic backwards in another order)."""
    jcfg, cfg, params, model, batch = _setup(
        attention_probs_dropout_prob=attn_dropout)
    rng = jax.random.PRNGKey(5) if attn_dropout else None

    def jloss(p):
        return JM.forward_train(p, _jax_batch(batch), jcfg, rng)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    seeds = (_jax_layer_seeds(rng, cfg.decoder_layers) if attn_dropout
             else None)
    loss, aux = TM.forward_train(model, _torch_batch(batch), cfg,
                                 layer_seeds=seeds)
    for key in ("loss", "masked_loss", "tag_loss"):
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=2e-5, err_msg=key)
    for key in ("class_logits", "tag_logits", "masked_weight"):
        np.testing.assert_allclose(aux[key].detach().numpy(),
                                   np.asarray(jaux[key]), rtol=2e-5,
                                   atol=2e-5, err_msg=key)
    loss.backward()
    got = _grads_np(model)
    ref = TB.flatten_params(jax.tree_util.tree_map(np.asarray, jg))
    assert got.keys() == ref.keys()
    for path, want in ref.items():
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=1e-4 * scale, err_msg=path)


@pytest.mark.parametrize("remat", [False, True])
def test_train_fused_blocks_match_jax(interpret, monkeypatch, remat):
    """cfg.train_fused_blocks: the JAX side with VITCAP_PALLAS=interpret
    (its fused_vit_block custom_vjp: the inference kernel forward, the
    plain chain recomputed backward), the port's trunk through
    fused_vit_block_train.  The 65 trunk tokens pad to 80 once
    (l_actual 65).  Loss, its parts, the logits and every gradient at the
    tolerances above; every trunk block and every tag block but the
    CLS-only last one take the inference forward once and the recompute
    once; remat changes nothing (no checkpoint wraps them, as in JAX)."""
    from vitcap_tpu_torch.models import layers as TL
    from vitcap_tpu_torch.ops import fused_block as TFB
    monkeypatch.setenv("VITCAP_PALLAS", "interpret")
    jcfg, cfg, params, model, batch = _setup(train_fused_blocks=True,
                                             remat=remat)
    assert cfg.use_remat == remat

    def jloss(p):
        return JM.forward_train(p, _jax_batch(batch), jcfg, None)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    calls = {"forward": [], "recompute": []}
    fwd, plain = TFB.fused_vit_block, TL._vit_block_plain

    def forward(p, x, nh, eps, l_actual=0):
        calls["forward"].append((x.shape[1], l_actual))
        return fwd(p, x, nh, eps, l_actual)

    def recompute(p, x, *a, **kw):
        calls["recompute"].append(x.shape[1])
        return plain(p, x, *a, **kw)
    monkeypatch.setattr(TFB, "fused_vit_block", forward)
    monkeypatch.setattr(TL, "_vit_block_plain", recompute)
    loss, aux = TM.forward_train(model, _torch_batch(batch), cfg)
    n_blocks = cfg.num_hidden_layers + cfg.split_blocks - 1
    assert calls["forward"] == [(80, 65)] * n_blocks
    for key in ("loss", "masked_loss", "tag_loss"):
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=2e-5, err_msg=key)
    for key in ("class_logits", "tag_logits"):
        np.testing.assert_allclose(aux[key].detach().numpy(),
                                   np.asarray(jaux[key]), rtol=2e-5,
                                   atol=2e-5, err_msg=key)
    loss.backward()
    assert calls["recompute"] == [65] * n_blocks
    got = _grads_np(model)
    ref = TB.flatten_params(jax.tree_util.tree_map(np.asarray, jg))
    assert got.keys() == ref.keys()
    for path, want in ref.items():
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=1e-4 * scale, err_msg=path)


def test_dropout_changes_the_loss_and_is_reproducible(interpret):
    """Dropout seeds drawn from a torch.Generator: the same generator seed
    gives the same logits, another seed or none other logits."""
    _, cfg, _, model, batch = _setup(attention_probs_dropout_prob=0.3)
    tb = _torch_batch(batch)
    with torch.no_grad():
        a = TM.forward_train(model, tb, cfg, torch.Generator().manual_seed(1))
        b = TM.forward_train(model, tb, cfg, torch.Generator().manual_seed(1))
        c = TM.forward_train(model, tb, cfg, torch.Generator().manual_seed(2))
        d = TM.forward_train(model, tb, cfg)
    logits = [r[1]["class_logits"] for r in (a, b, c, d)]
    assert torch.equal(logits[0], logits[1])
    assert not torch.equal(logits[0], logits[2])
    assert not torch.equal(logits[0], logits[3])


def test_remat_gives_the_same_gradients(interpret):
    """remat=True recomputes every block in the backward: same loss and
    gradients as keeping the residuals ('auto' resolves to no remat)."""
    _, cfg, _, model, batch = _setup()
    assert not cfg.use_remat and not cfg.use_remat_fusion
    assert cfg.replace(remat="fusion").use_remat_fusion
    tb = _torch_batch(batch)
    TM.forward_train(model, tb, cfg)[0].backward()
    ref = _grads_np(model)
    model.zero_grad(set_to_none=True)
    TM.forward_train(model, tb, cfg.replace(remat=True))[0].backward()
    got = _grads_np(model)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=1e-5,
                                   atol=1e-7, err_msg=path)


def test_forward_score_matches_jax():
    jcfg, cfg, params, model, batch = _setup()
    T = cfg.max_seq_len
    mask = np.tril(np.ones((B, T, T), np.float32))
    ref = JM.forward_score(params, jnp.asarray(batch["image"]),
                           jnp.asarray(batch["input_ids"]), None, None,
                           jnp.asarray(mask), jcfg)
    with torch.no_grad():
        out = TM.forward_score(model, torch.from_numpy(batch["image"]),
                               torch.from_numpy(batch["input_ids"]).long(),
                               None, None, torch.from_numpy(mask), cfg)
    np.testing.assert_allclose(out["class_logits"].numpy(),
                               np.asarray(ref["class_logits"]), rtol=2e-5,
                               atol=2e-5)


def test_gen_tag_ratio_mixes_gt_tags_first_sep_last():
    cfg = TC.tiny_config(topk=6)
    label = torch.zeros(3, cfg.tag_vocab_size)
    label[0, [3, 9, 40, 41]] = 1          # 4 GT tags
    label[1, 5] = 1                       # 1
    pred = torch.arange(100, 106).repeat(3, 1)
    g = torch.Generator().manual_seed(0)
    out = TM.mix_gt_tags(pred, label, 0.5, cfg, g)
    # floor(0.5 * n_gt) GT slots first, then the predictions, SEP last
    assert set(out[0, :2].tolist()) <= {3, 9, 40, 41}
    assert len(set(out[0, :2].tolist())) == 2
    assert out[0, 2:5].tolist() == [102, 103, 104]
    assert out[1, :5].tolist() == [100, 101, 102, 103, 104]
    assert out[2, :5].tolist() == [100, 101, 102, 103, 104]
    assert (out[:, -1] == cfg.sep_token_id).all()
    full = TM.mix_gt_tags(pred, label, 0.0, cfg, g)
    assert sorted(full[0, :4].tolist()) == [3, 9, 40, 41]
    assert full[1, 0].item() == 5 and full[1, 1].item() == 101
    # the generator sets the order: a run of draws shows more than one
    orders = {tuple(TM.mix_gt_tags(pred, label, 0.0, cfg, g)[0, :4].tolist())
              for _ in range(8)}
    assert len(orders) > 1
    _, tcfg, _, model, batch = _setup()
    tb = dict(_torch_batch(batch), gen_tag_ratio=0.0)
    loss, _ = TM.forward_train(model, tb, tcfg, torch.Generator())
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TO.SCHEDULES))
def test_schedules_match_jax(name):
    for warm, total in ((0, 40), (7, 40)):
        jf = JO.SCHEDULES[name](warm, total)
        tf = TO.SCHEDULES[name](warm, total)
        for step in range(total + 3):
            np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} {step}")


def test_caption_param_hypers_match_jax():
    _, cfg, params, model, _ = _setup()
    kw = dict(weight_decay=0.05, lr_multiplier=0.1)
    jl, jw = JO.caption_param_hypers(params, cfg.split_blocks,
                                     cfg.num_hidden_layers, **kw)
    names = [n for n, _ in model.named_parameters()]
    lr, wd = TO.caption_param_hypers(names, cfg.split_blocks,
                                     cfg.num_hidden_layers, **kw)
    jl, jw = TB.flatten_params(jl), TB.flatten_params(jw)
    for n, p in model.named_parameters():
        path, _ = TB.torch_name_to_jax_path(n, p.dim())
        assert lr[n] == jl[path] and wd[n] == jw[path], n
    # the quirk: BERT LayerNorm scales do not decay, ViT norm scales do
    assert wd["bert.decoder.layer.0.output.LayerNorm.weight"] == 0.0
    assert wd["bert.encoder.blocks.0.norm1.weight"] == 0.05
    assert lr["bert.encoder.blocks.0.norm1.weight"] == 0.1
    assert lr["bert.encoder.blocks.3.norm1.weight"] == 1.0


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rs = np.random.RandomState(2)
    g = {f"w{i}": rs.randn(5, i + 1).astype(np.float32) for i in range(4)}
    jc, jn = JO.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                    max_norm)
    tc, tn = TO.clip_by_global_norm({k: torch.from_numpy(v)
                                     for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-8)


def test_adamw_update_matches_jax():
    rs = np.random.RandomState(3)
    shapes = {"a": (4, 3), "b": (7,)}
    p = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    m = {k: rs.randn(*s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    v = {k: rs.rand(*s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    lm, wd = {"a": 0.1, "b": 1.0}, {"a": 0.05, "b": 0.0}
    cfg = JO.AdamWConfig(base_lr=1e-2)
    sched = JO.warmup_linear(2, 10)
    j = lambda d: {k: jnp.asarray(x) for k, x in d.items()}  # noqa: E731
    jp, js = JO.adamw_update(j(g), JO.AdamWState(jnp.int32(3), j(m), j(v)),
                             j(p), lm, wd, cfg, sched)
    t = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}  # noqa: E731,E501
    tp = t(p)
    ts = TO.adamw_update(t(g), TO.AdamWState(3, t(m), t(v)), tp, lm, wd,
                         TO.AdamWConfig(base_lr=1e-2),
                         TO.warmup_linear(2, 10))
    assert ts.step == 4
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                   rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def test_two_train_steps_match_jax(interpret):
    """Two make_train_step steps at dropout 0: loss, grad_norm, lr_mult,
    the probes, the new parameters and both Adam moments.  Tolerances, f32:
    losses and norms 2e-5; first moments 1e-4 of their leaf's scale (the
    gradients'); second moments 3e-4 of theirs (squares double the
    relative error), with a floor of 1e-8 (1e-16 for the squares) under
    which a leaf is rounding noise of a gradient that is zero in exact
    arithmetic (the attention key bias); parameters 2e-3 of lr around their
    values, since the first Adam step sends near-zero gradients to +-lr
    steps and amplifies their f32 differences."""
    jcfg, cfg, params, model, batch = _setup()
    hyper = dict(base_lr=1e-3, max_iter=20, warmup_steps=1)
    jstate = JT.init_train_state(params, jax.random.PRNGKey(1))
    jstep = jax.jit(JT.make_train_step(jcfg, JT.TrainHyper(**hyper)))
    tstate = TT.init_train_state(model, None)
    tstep = TT.make_train_step(cfg, TT.TrainHyper(**hyper))
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for key in ("loss", "masked_loss", "tag_loss", "grad_norm",
                    "lr_mult", "caption_acc", "tag_precision"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=2e-5, atol=1e-7, err_msg=key)
    assert tstate.opt.step == int(jstate.opt.step) == 2
    lr = hyper["base_lr"]
    got = TB.state_to_jax_flat(dict(model.named_parameters()))
    ref = TB.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params))
    for path, want in ref.items():
        np.testing.assert_allclose(got[path], want, rtol=0, atol=2e-3 * lr,
                                   err_msg=path)
    for what, tree, jtree, tol, floor in (
            ("mu", tstate.opt.mu, jstate.opt.mu, 1e-4, 1e-8),
            ("nu", tstate.opt.nu, jstate.opt.nu, 3e-4, 1e-16)):
        got = TB.state_to_jax_flat(tree)
        ref = TB.flatten_params(jax.tree_util.tree_map(np.asarray, jtree))
        for path, want in ref.items():
            scale = max(float(np.abs(want).max()), floor)
            np.testing.assert_allclose(got[path], want, rtol=0,
                                       atol=tol * scale,
                                       err_msg=f"{what} {path}")


def test_tag_losses_match_jax():
    """The four elementwise tag losses of models/losses.py."""
    from vitcap_tpu.models import losses as JLo
    from vitcap_tpu_torch.models import losses as TLo
    rs = np.random.RandomState(4)
    pred = rs.randn(3, 40).astype(np.float32) * 3
    guide = rs.randn(3, 40).astype(np.float32)
    hard = (rs.rand(3, 40) < 0.2).astype(np.float32)
    soft = np.where(rs.rand(3, 40) < 0.3, rs.rand(3, 40), 0.0) \
        .astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    pairs = [
        (JLo.focal_neg_loss(j(pred), j(hard)),
         TLo.focal_neg_loss(t(pred), t(hard))),
        (JLo.distill_focal_neg_loss(j(pred), j(soft), j(guide), t=2.0),
         TLo.distill_focal_neg_loss(t(pred), t(soft), t(guide), t=2.0)),
        (JLo.soft_focal_neg_loss(j(pred), j(soft)),
         TLo.soft_focal_neg_loss(t(pred), t(soft))),
        (JLo.smooth_focal_bce_loss(j(pred), j(hard)),
         TLo.smooth_focal_bce_loss(t(pred), t(hard))),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        TM.bce_tag_loss(t(pred), t(hard)).item(),
        float(JM.bce_tag_loss(j(pred), j(hard))), rtol=1e-6)
