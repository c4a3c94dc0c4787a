"""vitcap_tpu_torch 512-px training vs the JAX package, on the CPU.

Past 1024 padded tokens a gradient-carrying trace leaves the split train
blocks and takes the plain chain, whose self-attention is the packed
kernel pair on separate q, k, v (K8 non-slab: vitcap_tpu/ops/
flash_attention.py _flash_fwd_packed / _flash_bwd_packed, reached through
flash_attention_packed).  The JAX side runs with
VITCAP_TRAIN_PALLAS=interpret, so those kernels run in interpret mode; the
port's flash_attention_packed runs its kernels' plain versions here (a CPU
tensor).  The dropout keep bits are the same counter hash on both sides,
so runs with attention dropout are held at deterministic tolerances given
the JAX seeds.  Tolerances as in tests/test_torch_train_kernels.py: f32
values within 2e-5 of their scale and gradients within 1e-4 of each
leaf's; bf16 at least 99% of values bit-equal.

The model tests use tiny_config(img_size=384) weights (a 24 x 24
pos-embed grid) on 512 x 512 images: 1025 visual tokens padded to 1152 in
the trunk, 16 text + 1 tag CLS + 1025 visual = 1042 decoder tokens padded
to 1056.  The JAX results are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import layers as JL
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.ops import flash_attention as JFA
from vitcap_tpu.solver import train_step as JT

from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import layers as TL
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.ops.attention import attention_plain, attention_qkv_plain
from vitcap_tpu_torch.ops.attention_bwd import (attention_bwd_plain,
                                                attention_bwd_qkv_plain)
from vitcap_tpu_torch.ops.flash_attention import (flash_attention_packed,
                                                  flash_attention_packed_plain)
from vitcap_tpu_torch.solver import checkpoint_bridge as TB
from vitcap_tpu_torch.solver import train_step as TT

B = 2
IMG = 512
KW = dict(img_size=384, tag_loss_weight=1.0)
SEED = -123457


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def interpret():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("VITCAP_TRAIN_PALLAS", "interpret")
        yield m


def _j2t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _agree(out, ref, dtype, tol=2e-5):
    """f32: within tol of the reference's scale; bf16: at least 99% of the
    values bit-equal (the roundings are the TPU kernels'; only f32 sums
    taken in another order can split a rare value by one ulp)."""
    ref = _j2t(ref, dtype)
    out = out.detach()
    if dtype == torch.float32:
        scale = max(1.0, ref.abs().max().item())
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                                   atol=tol * scale)
    else:
        eq = (out == ref).float().mean().item()
        assert eq >= 0.99, eq
        np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                                   rtol=0, atol=2e-2 * ref.abs().max().item())


def _bias(L, seed):
    """A head-broadcast (B, 1, L, L) additive mask with every row keeping
    key 0."""
    rs = np.random.RandomState(seed)
    b = np.where(rs.rand(B, 1, L, L) > 0.25, 0.0, -10000.0)
    b[..., 0] = 0.0
    return b.astype(np.float32)


# ---------------------------------------------------------------------------
# flash_attention_packed, forward and backward
# ---------------------------------------------------------------------------

# (layout, heads, head dim, L, l_actual): "vit" is chunk views of one
# (B, L, 3H) qkv tensor, pre-padded, no bias, rate 0; "bert" separate q, k,
# v with a (B, 1, L, L) bias and rate 0.1 (l_actual 0: unpadded, the TPU
# function pads to 16 inside).  hd 64: the TPU package's pair kernels;
# hd 32: its per-head kernels.
PACKED_CASES = [("vit", 2, 64, 1152, 1025), ("vit", 4, 32, 80, 77),
                ("bert", 4, 32, 1056, 1042), ("bert", 2, 64, 1056, 1042),
                ("bert", 2, 64, 90, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,nh,hd,L,l_actual", PACKED_CASES)
def test_flash_attention_packed_matches_jax(dtype, layout, nh, hd, L,
                                            l_actual):
    H = nh * hd
    rs = np.random.RandomState(L + hd)
    qkv = rs.randn(B, L, 3 * H).astype(np.float32)
    g = rs.randn(B, L, H).astype(np.float32)
    if l_actual:
        g[:, l_actual:] = 0.0      # the caller's slice: padded rows get none
    rate = 0.1 if layout == "bert" else 0.0
    bias = _bias(L, hd) if layout == "bert" else None
    jdt = _jdt(dtype)
    jq, jk, jv = jnp.split(jnp.asarray(qkv, jdt), 3, axis=-1)
    jb = None if bias is None else jnp.asarray(bias)

    def jf(q, k, v):
        return JFA.flash_attention_packed(q, k, v, jb, jnp.int32(SEED), nh,
                                          True, rate, l_actual)
    jout, vjp = jax.vjp(jf, jq, jk, jv)
    jgrads = vjp(jnp.asarray(g, jdt))

    if layout == "vit":
        base = torch.from_numpy(qkv).to(dtype).requires_grad_(True)
        q, k, v = base.chunk(3, dim=-1)
        leaves = [base]
    else:
        leaves = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
                  .requires_grad_(True) for a in np.split(qkv, 3, axis=-1)]
        q, k, v = leaves
    tb = None if bias is None else torch.from_numpy(bias)
    out = flash_attention_packed(q, k, v, tb, SEED, nh, rate, l_actual)
    assert out.shape == (B, L, H)
    valid = l_actual or L
    _agree(out[:, :valid], np.asarray(jout, np.float32)[:, :valid], dtype)
    out.backward(torch.from_numpy(g).to(dtype))
    if layout == "vit":
        got = base.grad.split(H, dim=-1)
    else:
        got = [t.grad for t in leaves]
    for gt, want in zip(got, jgrads):
        _agree(gt, np.asarray(want, np.float32), dtype)
    if l_actual:
        # padded queries with no upstream gradient give none; padded keys
        # take none
        for gt in got:
            assert not gt[:, l_actual:].float().abs().any()


def test_plain_non_slab_on_slab_views_equals_slab_plain():
    """The non-slab plain versions on three views of a slab give the slab
    route's plain results bit for bit (forward and backward, bf16, bias and
    dropout), and flash_attention_packed on CPU tensors is its plain
    version."""
    g = torch.Generator().manual_seed(5)
    nh, H, Lp, L = 2, 128, 96, 90
    slab = torch.randn(B, Lp, 3 * H, generator=g).bfloat16()
    up = torch.randn(B, Lp, H, generator=g).bfloat16()
    bias = torch.from_numpy(_bias(Lp, 3))
    q, k, v = slab.split(H, dim=-1)
    assert torch.equal(attention_qkv_plain(q, k, v, nh, L, bias, 0.1, 9),
                       attention_plain(slab, nh, L, bias, 0.1, 9))
    for a, b in zip(attention_bwd_qkv_plain(q, k, v, up, nh, L, bias, 0.1, 9),
                    attention_bwd_plain(slab, up, nh, L, bias, 0.1, 9)):
        assert torch.equal(a, b)
    outs = []
    for fn in (flash_attention_packed, flash_attention_packed_plain):
        x = slab.clone().requires_grad_(True)
        o = fn(*x.split(H, dim=-1), bias, 9, nh, 0.1, L)
        o.backward(up)
        outs.append((o, x.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    with pytest.raises(ValueError, match="bias"):
        flash_attention_packed(q, k, v, bias.requires_grad_(True), 0, nh)
    with pytest.raises(ValueError, match="16-aligned"):
        flash_attention_packed(q[:, :90], k[:, :90], v[:, :90], None, 0, nh,
                               l_actual=80)


# ---------------------------------------------------------------------------
# the plain chain: blocks past 1024 and at unaligned lengths
# ---------------------------------------------------------------------------

def _models(nh, hd):
    """A JAX param tree and the port model holding the same weights, with
    non-zero biases and LayerNorm shifts so their gradients are tested."""
    H = nh * hd
    kw = dict(hidden_size=H, intermediate_size=4 * H, num_attention_heads=nh)
    params = jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(0),
                                   jax_tiny_config(**kw)))
    rs = np.random.RandomState(11)
    for path, a in TB.flatten_params(params).items():
        if path.endswith("bias"):
            a[...] = rs.randn(*a.shape).astype(np.float32) * 0.05
    model = TB.load_jax_params(TM.ViTCAP(TC.tiny_config(**kw)), params)
    return params, model.requires_grad_(True)


@pytest.fixture(scope="module")
def blocks():
    return _models(2, 64)


def _assert_grads(model, prefix, jgrads, atol_scale=1e-4):
    """Every parameter gradient of the port under `prefix` (a JAX path)
    within atol_scale of the JAX leaf's scale."""
    named = dict(model.named_parameters())
    flat = TB.flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert flat
    for path, ref in flat.items():
        name, transform = TB.jax_path_to_torch_name(prefix + path)
        want = TB._apply_transform(np.asarray(ref, np.float32), transform)
        got = named[name].grad
        assert got is not None, name
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=atol_scale * scale, err_msg=name)


def _jax_attn_seed(rng):
    """The attention seed of JAX's plain BERT chain: _bert_layer_xla splits
    the layer key in three and mha draws bits from the first
    (vitcap_tpu/models/layers.py:564-569, :147-148)."""
    r1 = jax.random.split(rng, 3)[0]
    return int(jax.lax.bitcast_convert_type(
        jax.random.bits(r1, (), jnp.uint32), jnp.int32))


def _block_run(params, model, kind, x, L, l_actual, dtype, bias=None,
               rate=0.0, rng=None):
    """One train call of a ViT block or BERT layer (2 heads of 64) on both
    sides: (port output, port input, JAX output, JAX parameter gradients,
    JAX input gradient); the port's parameter gradients are left on its
    model.  Loss: the sum of squares over the valid rows."""
    nh = 2
    jdt = _jdt(dtype)
    if kind == "vit":
        jp, p = params["encoder"]["blocks"][0], model.bert.encoder.blocks[0]
    else:
        jp, p = params["decoder"]["layer"][0], model.bert.decoder.layer[0]
    jb = None if bias is None else jnp.asarray(bias)

    def jloss(pp, xx):
        if kind == "vit":
            o = JL.vit_block(pp, xx, nh, 1e-6, l_actual=l_actual)
        else:
            o = JL.bert_layer(pp, xx, jb, nh, 1e-12, attn_dropout=rate,
                              rng=rng, deterministic=rng is None,
                              l_actual=l_actual)
        return jnp.sum(o[:, :L].astype(jnp.float32) ** 2), o
    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jp, jnp.asarray(x, jdt))
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    model.zero_grad(set_to_none=True)
    if kind == "vit":
        out = TL.vit_block(p, xt, nh, 1e-6, l_actual=l_actual)
    else:
        seeds = None if rng is None else (_jax_attn_seed(rng), 0)
        out = TL.bert_layer(p, xt, torch.from_numpy(bias), nh, 1e-12,
                            attn_dropout=rate, seeds=seeds,
                            l_actual=l_actual)
    (out[:, :L].float() ** 2).sum().backward()
    return out, xt, jout, jgp, jgx


def test_vit_block_past_1024_matches_jax(blocks):
    """vit_block train call at (2, 1152, 128), l_actual 1025: the plain
    chain with the packed attention on both sides; output, input gradient
    and every parameter gradient, f32."""
    params, model = blocks
    rs = np.random.RandomState(3)
    x = rs.randn(B, 1152, 128).astype(np.float32)
    out, xt, jout, jgp, jgx = _block_run(params, model, "vit", x, 1025, 1025,
                                         torch.float32)
    _agree(out[:, :1025], np.asarray(jout)[:, :1025], torch.float32)
    _agree(xt.grad, np.asarray(jgx), torch.float32, 1e-4)
    assert not xt.grad[:, 1025:].abs().any()
    _assert_grads(model, "encoder/blocks/0/", jgp)


def test_bert_layer_past_1024_matches_jax(blocks):
    """bert_layer train call at L = 1042 pre-padded to 1056, with the
    (B, 1, L, L) bias and attention dropout 0.1 from JAX's seed for the
    plain chain (not the split route's)."""
    params, model = blocks
    rs = np.random.RandomState(4)
    x = rs.randn(B, 1056, 128).astype(np.float32)
    bias = _bias(1056, 13)
    rng = jax.random.fold_in(jax.random.PRNGKey(7), 1)
    out, xt, jout, jgp, jgx = _block_run(params, model, "bert", x, 1042,
                                         1042, torch.float32, bias, 0.1, rng)
    _agree(out[:, :1042], np.asarray(jout)[:, :1042], torch.float32)
    _agree(xt.grad[:, :1042], np.asarray(jgx)[:, :1042], torch.float32, 1e-4)
    _assert_grads(model, "decoder/layer/0/", jgp)


def test_unaligned_train_attention_matches_jax_packed(blocks):
    """At an unaligned L >= 64 the JAX package's train attention is the
    packed kernel (padded to 16 inside), so the port's mha train route is
    too: at L = 72 in bf16, with the head-broadcast bias and attention
    dropout 0.1 from JAX's seed, the output and dq, dk, dv are at least 99%
    bit-equal (the plain attention, which normalised before rounding and
    drew its dropout from a generator, did not match); and a BERT layer
    train call at L = 72 with dropout matches in f32, every gradient
    included."""
    rs = np.random.RandomState(6)
    nh, L, H = 2, 72, 128
    q, k, v, g = (rs.randn(B, L, H).astype(np.float32) for _ in range(4))
    bias = _bias(L, 8)
    rng = jax.random.PRNGKey(21)
    seed = int(jax.lax.bitcast_convert_type(
        jax.random.bits(rng, (), jnp.uint32), jnp.int32))
    jb = jnp.asarray(bias)

    def jf(a, b, c):
        return JL.mha(a, b, c, nh, jb, dropout_rate=0.1, rng=rng,
                      deterministic=False)
    jout, vjp = jax.vjp(jf, *(jnp.asarray(a, jnp.bfloat16)
                              for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g, jnp.bfloat16))
    ts = [torch.from_numpy(a).bfloat16().requires_grad_(True)
          for a in (q, k, v)]
    out = TL.mha(*ts, nh, torch.from_numpy(bias), dropout_rate=0.1,
                 seed=seed)
    _agree(out, np.asarray(jout, np.float32), torch.bfloat16)
    out.backward(torch.from_numpy(g).bfloat16())
    for t, want in zip(ts, jgrads):
        _agree(t.grad, np.asarray(want, np.float32), torch.bfloat16)

    params, model = blocks
    x = rs.randn(B, L, H).astype(np.float32)
    out, xt, jout, jgp, jgx = _block_run(params, model, "bert", x, L, 0,
                                         torch.float32, bias, 0.1,
                                         jax.random.PRNGKey(22))
    _agree(out, np.asarray(jout), torch.float32)
    _agree(xt.grad, np.asarray(jgx), torch.float32, 1e-4)
    _assert_grads(model, "decoder/layer/0/", jgp)


# ---------------------------------------------------------------------------
# forward_train and two train steps at 512 px
# ---------------------------------------------------------------------------

def _batch(cfg, rs):
    T, A = cfg.max_seq_len, cfg.max_seq_a_len
    masked_pos = np.zeros((B, T), np.int32)
    masked_pos[0, [1, 2, 4]] = 1
    masked_pos[1, [3, 5]] = 1
    label = (rs.rand(B, cfg.tag_vocab_size) < 0.05).astype(np.float32)
    label[:, 7] = 1.0
    batch = {
        "image": rs.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8),
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
    return batch


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
    return jcfg, cfg, params, model, _batch(cfg, rs)


def _torch_batch(batch):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t.long() if t.dtype == torch.int32 else t
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads_np(model):
    return TB.state_to_jax_flat(
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in model.named_parameters()})


def test_forward_train_512_matches_jax():
    """forward_train at 384-px weights on 512 x 512 images, attention
    dropout 0.1, hidden dropout 0: loss, its parts, the logits and every
    gradient (pos_embed's through the bicubic resize included).  The trunk
    runs the plain chain at 1152 (l_actual 1025), the decoder at 1056
    (l_actual 1042); the port gets the attention seeds of JAX's plain BERT
    chain."""
    jcfg, cfg, params, model, batch = _setup(
        attention_probs_dropout_prob=0.1)
    rng = jax.random.PRNGKey(5)

    def jloss(p):
        return JM.forward_train(p, _jax_batch(batch), jcfg, rng)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    _, r_dec = jax.random.split(rng)
    seeds = [(_jax_attn_seed(jax.random.fold_in(r_dec, li)), 0)
             for li in range(cfg.decoder_layers)]
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
    assert np.abs(ref["image_encoder/pos_embed"]).max() > 0
    for path, want in ref.items():
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=1e-4 * scale, err_msg=path)


def test_two_train_steps_512_match_jax():
    """Two make_train_step steps at 512 px, dropout 0, as
    tests/test_torch_train_step.py's test_two_train_steps_match_jax at 128
    px and with its tolerances: losses and norms 2e-5; parameters 2e-3 of
    lr; first moments 1e-4 and second moments 3e-4 of their leaf's
    scale (floors 1e-8 and 1e-16)."""
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
