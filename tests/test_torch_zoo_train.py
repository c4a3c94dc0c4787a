"""The port's zoo train mode (vitcap_tpu_torch/models/backbones.py:
model.train(), zoo_train_mode, drop_path, head_dropout) vs the JAX
package's (zoo_train_mode, bn_updated_params, jax.grad) on the CPU, f32,
64-px seeded images, B=2:

- at drop rates 0, for resnet, efficientnet (and a tf_ twin: momentum
  0.01, TF-'SAME'), mobilenetv3, regnet and a BN hybrid stem under a tiny
  ViT: in f32, the train-mode logits and the updated running statistics,
  each within 1e-4 of its tensor's largest magnitude; in f64, every
  parameter's gradient (of sum(logits * r), r seeded) within 1e-6 of the
  model's largest gradient.  The gradients are held in f64 because
  through train BatchNorms at B=2 they are ill-conditioned: either side's
  f32 backward strays from its f64 one by 1e-4 to 3e-2 of the largest
  gradient, with the summation order (regnety_004's stem, as torch's
  thread count changes).  The JAX side runs under jax.enable_x64 with
  its modules' float32 read as float64 (its train BatchNorm, LayerNorm
  and softmax hold their statistics in float32): its formulas, evaluated
  wide;
- drop-path and head dropout as exact transforms given the JAX package's
  own uniform draws, their masks' statistics from a torch.Generator, the
  gradient through a dropped branch, and the identity in eval;
- a model after a train forward: its mode restored, its parameters
  unchanged, its eval output unchanged once its running statistics are
  put back.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_train.py -q
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import backbones as JB
from vitcap_tpu.models import efficientnet as JE
from vitcap_tpu.models import layers as JL
from vitcap_tpu.models import registry as JR

from vitcap_tpu_torch.models import backbones as TB
from vitcap_tpu_torch.models import registry as TR

from test_torch_zoo_cnn import _skeleton
from test_torch_zoo_effnet import (  # noqa: F401 (one_torch_thread: autouse)
    imgs, jax_load, jax_spec, one_torch_thread, perturb_)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_to_scale(got, want, what, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


def _port_cnn(name, tmp_path):
    """The port model (seeded, perturbed) and its JAX tree."""
    spec = TR.model_spec(name, num_classes=10)
    gen = torch.Generator().manual_seed(5)
    if isinstance(spec, TR.CnnModelSpec):
        model = perturb_(TR.init_cnn_params(spec, gen, "cpu"))
        path = str(tmp_path / f"{name}.pth")
        torch.save(model.state_dict(), path)
        jp = JR.load_cnn_checkpoint(_skeleton(model), path, jax_spec(spec))
        return spec, model, jp, TR.cnn_forward, JR.cnn_forward
    model = perturb_(TR.init_pooled_cnn_params(spec, gen, "cpu"))
    path = str(tmp_path / f"{name}.pth")
    torch.save(model.state_dict(), path)
    fwd = getattr(JR, {"EffNetModelSpec": "effnet_forward",
                       "Mn3ModelSpec": "mn3_forward",
                       "RegNetModelSpec": "regnet_forward",
                       }[type(spec).__name__])
    return (spec, model, jax_load(model, spec, path),
            TR.pooled_cnn_forward, fwd)


def _port_hybrid():
    """vit_small_resnet26d_224's resnet26d stem (full width) under a tiny
    ViT (hidden 32, 2 blocks) at 64 px: the JAX init (traced once), BN
    statistics and affines redrawn, carried to the port."""
    spec = dataclasses.replace(TR.model_spec("vit_small_resnet26d_224"),
                               hidden_size=32, depth=2, num_heads=4,
                               img_size=64, num_classes=10)
    jspec = jax_spec(spec)
    jp = _np_tree(jax.jit(JR.init_vision_params, static_argnums=1)(
        jax.random.PRNGKey(0), jspec))
    rs = np.random.RandomState(9)

    def walk(node):
        if isinstance(node, dict) and {"mean", "var"} <= set(node):
            n = node["mean"].shape
            return dict(node, mean=0.1 * rs.randn(*n).astype(np.float32),
                        var=(1 + 0.2 * np.abs(rs.randn(*n))).astype(
                            np.float32),
                        scale=(1 + 0.1 * rs.randn(*n)).astype(np.float32),
                        bias=0.1 * rs.randn(*n).astype(np.float32))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    jp = walk(jp)
    model = TR.init_vision_params(spec, torch.Generator().manual_seed(1),
                                  "cpu")
    TR.load_zoo_state(model, TR.zoo_params_from_jax(jp, spec))
    return spec, model, jax.tree_util.tree_map(jnp.asarray, jp), \
        TR.vit_forward, JR.vit_forward


class _Wide:
    """jax.numpy with float32 read as float64: the JAX package's forwards,
    whose train BatchNorm, LayerNorm and softmax hold their statistics in
    float32, evaluated in float64 (under jax.enable_x64)."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


TRAIN_CASES = ["resnet26", "efficientnet_b0", "tf_efficientnet_b0",
               "mobilenetv3_large_100", "regnety_004", "hybrid_resnet26d"]


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_forward_stats_and_grads_match_jax(tmp_path, monkeypatch,
                                                 case):
    if case.startswith("hybrid"):
        spec, model, jp, tfwd, jfwd = _port_hybrid()
    else:
        spec, model, jp, tfwd, jfwd = _port_cnn(case, tmp_path)
    jspec = jax_spec(spec)
    momentum = JE.effnet_bn_momentum(spec.name)
    x = imgs(64) * 0.5
    r = np.random.RandomState(1).randn(2, 10)

    def jax_train(p, a, dtype):
        with JB.zoo_train_mode(momentum=momentum) as tm:
            logits = jfwd(p, a, jspec, head=True, dtype=dtype)
            new = JB.bn_updated_params(p, tm)
        return jnp.sum(logits * r.astype(dtype)), (logits, new)

    # f32: the train-mode logits and the running statistics
    _, (want, new) = jax.jit(lambda p, a: jax_train(p, a, jnp.float32))(
        jp, jnp.asarray(x))
    f32 = copy.deepcopy(model).train()
    with torch.no_grad():
        got = tfwd(f32, torch.from_numpy(x), spec, head=True)
    _close_to_scale(got.numpy(), want, "logits")
    stats = TR.zoo_params_from_jax(_np_tree(new), spec)
    old = TR.zoo_params_from_jax(_np_tree(jp), spec)
    sd = f32.state_dict()
    running = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert running and set(running) <= set(stats)
    for k in running:
        _close_to_scale(sd[k].numpy(), stats[k].numpy(), k)
    assert any(not np.allclose(sd[k].numpy(), old[k].numpy())
               for k in running)

    # f64: every parameter's gradient
    for mod in (JB, JL, JR):
        monkeypatch.setattr(mod, "jnp", _Wide())
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), jp)
        grads, _ = jax.jit(jax.grad(jax_train, has_aux=True),
                           static_argnums=2)(
            jp64, jnp.asarray(x, jnp.float64), jnp.float64)
        jgrads = TR.zoo_params_from_jax(
            jax.tree_util.tree_map(np.asarray, grads), spec)
    f64 = copy.deepcopy(model).double().requires_grad_(True).train()
    out = tfwd(f64, torch.from_numpy(x).double(), spec, head=True,
               dtype=torch.float64)
    (out * torch.from_numpy(r)).sum().backward()
    params = dict(f64.named_parameters())
    assert set(params) <= set(jgrads)
    top = max(np.abs(jgrads[k].numpy()).max() for k in params)
    for k, p in params.items():
        err = np.abs(p.grad.numpy() - jgrads[k].numpy()).max()
        assert err <= 1e-6 * top, f"grad {k}: {err:.3e}, top {top:.3e}"


def test_bn_momentum_follows_the_variant():
    """torch's 0.1, and 0.01 for the TF-ported effnets (the JAX package's
    effnet_bn_momentum); eps 1e-3 there."""
    for name, mom, eps in (("efficientnet_b0", 0.1, 1e-5),
                           ("tf_efficientnet_b0", 0.01, 1e-3),
                           ("efficientnet_b1_pruned", 0.01, 1e-3),
                           ("mixnet_s", 0.1, 1e-5)):
        m = TR.create_model(name, device="cpu").params
        bns = [b for b in m.modules() if isinstance(b, torch.nn.BatchNorm2d)]
        assert bns and {(b.momentum, b.eps) for b in bns} == {(mom, eps)}
        assert JE.effnet_bn_momentum(name) == mom


def _jax_uniform(seed, shape):
    """The uniform draws JAX's zoo_train_mode makes for its first mask."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return np.array(jax.random.uniform(sub, shape, jnp.float32))


class _Given(TB.ZooTrainMode):
    """ZooTrainMode whose draws are given."""

    def __init__(self, u, **rates):
        super().__init__(**rates)
        self.u = u

    def uniform(self, shape, device):
        assert tuple(shape) == self.u.shape
        return torch.from_numpy(self.u)


@pytest.mark.parametrize("rate_scale", [1.0, 0.5])
def test_drop_path_is_jax_transform_given_the_mask(rate_scale):
    x = np.random.RandomState(2).randn(512, 3, 3, 8).astype(np.float32)
    with JB.zoo_train_mode(jax.random.PRNGKey(0), drop_path_rate=0.4):
        want = np.asarray(JB._drop_path(jnp.asarray(x), rate_scale))
    u = _jax_uniform(0, (512, 1, 1, 1))
    got = TB.drop_path(torch.from_numpy(x).permute(0, 3, 1, 2),
                       _Given(u, drop_path_rate=0.4), rate_scale)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_head_dropout_is_jax_transform_given_the_mask():
    x = np.random.RandomState(3).randn(64, 128).astype(np.float32)
    with JB.zoo_train_mode(jax.random.PRNGKey(1), drop_rate=0.25):
        want = np.asarray(JB._head_dropout(jnp.asarray(x)))
    got = TB.head_dropout(torch.from_numpy(x),
                          _Given(_jax_uniform(1, (64, 128)), drop_rate=0.25))
    np.testing.assert_array_equal(got.numpy(), want)


def test_drop_path_masks_and_gradient():
    """Per sample all or nothing, survivors scaled by 1 / keep, about keep
    of them kept; rate_scale 0 and eval are the identity; the gradient
    is mask / keep; one seed, one mask."""
    x = torch.ones(512, 8, 3, 3, requires_grad=True)
    tm = TB.ZooTrainMode(torch.Generator().manual_seed(0), 0.4)
    y = TB.drop_path(x, tm)
    per = y.detach().reshape(512, -1)
    kept = per[:, 0] > 0
    assert torch.equal(per[kept], torch.full_like(per[kept], 1 / 0.6))
    assert (per[~kept] == 0).all() and 0.5 < kept.float().mean() < 0.7
    y.sum().backward()
    assert torch.equal(x.grad, y.detach())
    assert TB.drop_path(x, tm, 0.0) is x and TB.drop_path(x, None) is x
    again = TB.drop_path(x, TB.ZooTrainMode(torch.Generator().manual_seed(0),
                                            0.4))
    assert torch.equal(again, y)
    with pytest.raises(ValueError, match="generator"):
        TB.drop_path(x, TB.ZooTrainMode(None, 0.4))


def test_head_dropout_masks():
    x = torch.ones(64, 128)
    y = TB.head_dropout(x, TB.ZooTrainMode(torch.Generator().manual_seed(1),
                                           drop_rate=0.25))
    assert set(torch.unique(y).tolist()) == {0.0, torch.tensor(1 / 0.75)
                                             .item()}
    assert 0.70 < (y > 0).float().mean() < 0.80
    assert TB.head_dropout(x, None) is x
    assert TB.head_dropout(x, TB.ZooTrainMode(drop_path_rate=0.5)) is x


def test_effnet_drop_path_live_in_train_only():
    """Drop-path changes a train forward with the generator's seed, not an
    eval one; the same seed gives the same output."""
    m = TR.create_model("efficientnet_b0", device="cpu", num_classes=10)
    x = torch.from_numpy(imgs(64, n=4))
    stats = {k: v.clone() for k, v in m.params.state_dict().items()}

    def run(seed):
        with torch.no_grad(), TB.zoo_train_mode(
                m.params, torch.Generator().manual_seed(seed),
                drop_path_rate=0.9):
            return m.apply(m.params, x, head=True)
    with torch.no_grad():
        base = m.apply(m.params, x, head=True)
    a, b, a2 = run(0), run(7), run(0)
    assert not torch.allclose(a, b) and torch.equal(a, a2)
    TR.load_zoo_state(m.params, stats)
    with torch.no_grad():
        assert torch.equal(m.apply(m.params, x, head=True).detach(), base)


@pytest.mark.parametrize("name", ["regnety_004", "mobilenetv3_small_075"])
def test_eval_unchanged_after_train_forward(name):
    """After a zoo_train_mode forward the model is back in eval, its
    parameters are as they were, its running statistics moved; with them
    put back its eval output is bit for bit the one before."""
    m = TR.create_model(name, device="cpu", num_classes=10)
    perturb_(m.params)
    x = torch.from_numpy(imgs(64))
    before = {k: v.clone() for k, v in m.params.state_dict().items()}
    with torch.no_grad():
        out0 = m.apply(m.params, x, head=True)
        with TB.zoo_train_mode(m.params, torch.Generator().manual_seed(3),
                               drop_path_rate=0.2, drop_rate=0.2) as tm:
            assert m.params.training and tm.drop_rate == 0.2
            m.apply(m.params, x, head=True)
    assert not m.params.training and not hasattr(m.params, "zoo_train")
    after = m.params.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert moved and all(k.endswith(("running_mean", "running_var"))
                         for k in moved)
    TR.load_zoo_state(m.params, before)
    with torch.no_grad():
        assert torch.equal(m.apply(m.params, x, head=True), out0)
