"""vitcap_tpu_torch.models.scan vs the JAX package's models/scan.py on the
CPU: each function on the same numpy inputs and weights
(scan_params_from_jax), f32 within 1e-5.  The port scores captions in
chunks of cap_chunk as the JAX package's lax.map does; a smaller chunk
changes no result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import scan as JS

from vitcap_tpu_torch.models import scan as S

TOL = dict(rtol=1e-5, atol=1e-5)
NORMS = ["softmax", "l2norm", "clipped_l2norm", "l1norm", "clipped_l1norm",
         "clipped", "no_norm"]
AGGS = ["LogSumExp", "Max", "Sum", "Mean"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _model(jcfg, tcfg, seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, JS.init_scan_params(jax.random.PRNGKey(seed), jcfg))
    model = S.ScanModel(tcfg)
    model.load_state_dict(S.scan_params_from_jax(params))
    return params, model


def _cfgs(**kw):
    return JS.ScanConfig(**kw), S.ScanConfig(**kw)


def _padded(rs, n, L, d, lens):
    x = rs.randn(n, L, d).astype(np.float32)
    for i, ln in enumerate(lens):
        x[i, ln:] = 0
    return x


def test_config_defaults_match():
    import dataclasses
    assert dataclasses.asdict(S.ScanConfig()) == dataclasses.asdict(
        JS.ScanConfig())


@pytest.mark.parametrize("norm", NORMS)
def test_func_attention(norm):
    jcfg, tcfg = _cfgs(raw_feature_norm=norm)
    rs = np.random.RandomState(0)
    q = rs.randn(3, 5, 16).astype(np.float32)
    c = rs.randn(3, 7, 16).astype(np.float32)
    qv = np.arange(5)[None] < np.array([5, 3, 1])[:, None]
    cv = np.arange(7)[None] < np.array([7, 2, 5])[:, None]
    jw, ja = JS.func_attention(jnp.asarray(q), jnp.asarray(c), jcfg,
                               smooth=jcfg.lambda_softmax,
                               q_valid=jnp.asarray(qv),
                               c_valid=jnp.asarray(cv))
    w, a = S.func_attention(_t(q), _t(c), tcfg, smooth=tcfg.lambda_softmax,
                            q_valid=_t(qv), c_valid=_t(cv))
    _close(w, jw)
    _close(a, ja)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("cross", ["t2i", "i2t"])
def test_scores(cross, agg):
    """The (n_img, n_cap) score matrix, at the JAX chunk and at chunks of
    2 captions."""
    jcfg, tcfg = _cfgs(agg_func=agg, cross_attn=cross, cap_chunk=8)
    rs = np.random.RandomState(1)
    n_img, n_cap, R, Lw, d = 4, 6, 6, 8, 16
    img = rs.randn(n_img, R, d).astype(np.float32)
    cap_lens = np.array([8, 5, 3, 7, 1, 6])
    img_lens = np.array([6, 4, 6, 5])
    cap = _padded(rs, n_cap, Lw, d, cap_lens)
    ref = JS.scan_scores(jnp.asarray(img), jnp.asarray(img_lens),
                         jnp.asarray(cap), jnp.asarray(cap_lens), jcfg)
    for chunk in (8, 2):
        got = S.scan_scores(_t(img), _t(img_lens), _t(cap), _t(cap_lens),
                            S.ScanConfig(agg_func=agg, cross_attn=cross,
                                         cap_chunk=chunk))
        assert got.shape == (n_img, n_cap)
        _close(got, ref)


@pytest.mark.parametrize("max_violation", [True, False])
def test_contrastive_loss(max_violation):
    jcfg, tcfg = _cfgs(max_violation=max_violation)
    rs = np.random.RandomState(3)
    n, R, Lw, d = 5, 6, 8, 16
    img = rs.randn(n, R, d).astype(np.float32)
    lens = np.array([8, 5, 3, 7, 6])
    cap = _padded(rs, n, Lw, d, lens)
    jscores = JS.scan_scores(jnp.asarray(img), None, jnp.asarray(cap),
                             jnp.asarray(lens), jcfg)
    scores = S.scan_scores(_t(img), None, _t(cap), _t(lens), tcfg)
    _close(S.contrastive_loss(scores, tcfg),
           JS.contrastive_loss(jscores, jcfg))
    # on the same scores too, where only the hinge is compared
    _close(S.contrastive_loss(_t(np.asarray(jscores)), tcfg),
           JS.contrastive_loss(jscores, jcfg))


@pytest.mark.parametrize("bi, layers", [(True, 1), (False, 1), (True, 2),
                                        (False, 0)],
                         ids=["bi", "uni", "bi_2layers", "embedding_only"])
def test_text_encoder(bi, layers):
    """encode_text over ragged lengths (the masked tail: zero outputs,
    the reverse direction from each caption's last token)."""
    kw = dict(vocab_size=50, word_dim=12, embed_size=10, num_layers=layers,
              bi_gru=bi)
    jcfg, tcfg = _cfgs(**kw)
    params, model = _model(jcfg, tcfg)
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 50, (4, 7))
    lens = np.array([7, 4, 1, 5])
    ref = JS.encode_text(jax.tree_util.tree_map(jnp.asarray, params),
                         jnp.asarray(ids), jnp.asarray(lens), jcfg)
    got = S.encode_text(model, _t(ids), _t(lens), tcfg)
    _close(got, ref)
    assert not got[2, 1:].any()


def test_image_encoder_and_init_ranges():
    jcfg, tcfg = _cfgs(img_dim=24, embed_size=10, vocab_size=30, word_dim=6)
    params, model = _model(jcfg, tcfg)
    feats = np.random.RandomState(5).randn(3, 4, 24).astype(np.float32)
    _close(S.encode_image(model, _t(feats), tcfg),
           JS.encode_image(params, jnp.asarray(feats), jcfg))
    fresh = S.init_scan_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert fresh.state_dict().keys() == model.state_dict().keys()
    r = (6.0 / (24 + 10)) ** 0.5
    assert fresh.img_proj.weight.abs().max() <= r
    assert not fresh.img_proj.bias.any()
    assert fresh.embed.weight.abs().max() <= 0.1
    assert fresh.gru[0][1].w_hh.abs().max() <= 10 ** -0.5


def test_retrieval_metrics():
    rs = np.random.RandomState(6)
    scores = rs.randn(6, 30).astype(np.float32)
    scores[np.arange(6), np.arange(6) * 5] += 3.0
    assert S.retrieval_metrics(_t(scores)) == JS.retrieval_metrics(
        jnp.asarray(scores))
    assert S.retrieval_metrics(scores, caps_per_image=5) == \
        JS.retrieval_metrics(scores, caps_per_image=5)


def test_three_train_steps():
    """Three Adam steps on the contrastive loss (torch.optim.Adam against
    optax.adam, both lr 1e-2): each step's loss."""
    import optax
    kw = dict(vocab_size=40, word_dim=8, embed_size=8, img_dim=12,
              num_layers=1, bi_gru=True, cap_chunk=4)
    jcfg, tcfg = _cfgs(**kw)
    params, model = _model(jcfg, tcfg)
    rs = np.random.RandomState(7)
    Bn, R, Lw = 8, 4, 6
    img = rs.randn(Bn, R, 12).astype(np.float32)
    ids = rs.randint(0, 40, (Bn, Lw))
    lens = np.array([6, 3, 5, 6, 2, 4, 6, 1])

    opt = optax.adam(1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = opt.init(jp)

    @jax.jit
    def jstep(p, st):
        loss, g = jax.value_and_grad(lambda p: JS.scan_forward(
            p, jnp.asarray(img), None, jnp.asarray(ids), jnp.asarray(lens),
            jcfg))(p)
        upd, st = opt.update(g, st)
        return optax.apply_updates(p, upd), st, loss

    topt = torch.optim.Adam(model.parameters(), lr=1e-2)
    for _ in range(3):
        jp, jst, jl = jstep(jp, jst)
        topt.zero_grad()
        loss = S.scan_forward(model, _t(img), None, _t(ids), _t(lens), tcfg)
        loss.backward()
        topt.step()
        np.testing.assert_allclose(loss.item(), float(jl), **TOL)
