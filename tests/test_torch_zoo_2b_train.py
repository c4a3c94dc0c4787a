"""The zoo's train mode on part 2b's BatchNorm placements, the port
(model.train()) vs the JAX package's (zoo_train_mode, bn_updated_params,
jax.grad) on the CPU, 64-px seeded images, B=2, at real channel widths:

- ResNeSt's and SKNet's BNs on the pooled (B, C, 1, 1) attention vector,
  DPN's eps 1e-3, TResNet's InplaceABN slopes (1e-2, 1e-3, none): in
  f32, the train-mode logits and every updated running statistic, each
  within 1e-4 of its tensor's largest magnitude;
- VoVNet's EvoNorm-S0: no running statistic anywhere, the logits within
  1e-4 of their scale and the state dict untouched by a train forward;
- resnest14d in f64: every parameter's gradient (of sum(logits * r), r
  seeded) within 1e-6 of the model's largest gradient, the JAX side
  under jax.enable_x64 with its modules' float32 read as float64 (as in
  test_torch_zoo_train.py: gradients through train BatchNorms at B=2 are
  too ill-conditioned for an f32 comparison).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_2b_train.py -q
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import backbones as JB
from vitcap_tpu.models import layers as JL
from vitcap_tpu.models import registry as JR

from vitcap_tpu_torch.models import registry as TR

from test_torch_zoo_2b_res import (  # noqa: F401 (one_torch_thread: autouse)
    _np_tree, family, imgs, jax_load, jax_spec, one_torch_thread,
    seeded_model)
from test_torch_zoo_train import _Wide, _close_to_scale

# (name, what its train mode covers)
TRAIN_CASES = [
    ("resnest14d", "bn1 on the pooled radix sum; f64 gradients"),
    ("skresnet18", "the attention BN on the pooled path sum"),
    ("dpn68", "eps 1e-3 in the pre-activation BNs"),
    ("tresnet_m", "InplaceABN's slopes, BN before the blur pool"),
    ("ese_vovnet39b_evos", "EvoNorm-S0: no statistics to update"),
]


def _port(name, tmp_path):
    spec = TR.model_spec(name, num_classes=10)
    model = seeded_model(spec, seed=5, calibrate=False)
    path = str(tmp_path / f"{name}.pth")
    torch.save(model.state_dict(), path)
    return spec, model, jax_load(spec, path)


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_train_forward_and_stats_match_jax(tmp_path, monkeypatch, name):
    spec, model, jp = _port(name, tmp_path)
    jspec = jax_spec(spec)
    jfwd = getattr(JR, f"{family(spec)}_forward")
    x = imgs(64) * 0.5
    r = np.random.RandomState(1).randn(2, 10)

    def jax_train(p, a, dtype):
        with JB.zoo_train_mode() as tm:
            logits = jfwd(p, a, jspec, head=True, dtype=dtype)
            new = JB.bn_updated_params(p, tm)
        return jnp.sum(logits * r.astype(dtype)), (logits, new)

    _, (want, new) = jax.jit(lambda p, a: jax_train(p, a, jnp.float32))(
        jp, jnp.asarray(x))
    f32 = copy.deepcopy(model).train()
    before = {k: v.clone() for k, v in f32.state_dict().items()}
    with torch.no_grad():
        got = TR.pooled_cnn_forward(f32, torch.from_numpy(x), spec,
                                    head=True)
    _close_to_scale(got.numpy(), want, "logits")
    sd = f32.state_dict()
    running = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    if name.endswith("_evos"):
        assert not running and all(torch.equal(before[k], sd[k])
                                   for k in sd)
        return
    stats = TR.zoo_params_from_jax(_np_tree(new), spec)
    old = TR.zoo_params_from_jax(_np_tree(jp), spec)
    assert running and set(running) <= set(stats)
    for k in running:
        _close_to_scale(sd[k].numpy(), stats[k].numpy(), k)
    pooled = [k for k in running if ".attn.bn." in k or "conv2.bn1." in k]
    assert bool(pooled) == (name in ("resnest14d", "skresnet18"))
    assert all(not np.allclose(sd[k].numpy(), old[k].numpy())
               for k in pooled)
    if name != "resnest14d":
        return

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
    out = TR.pooled_cnn_forward(f64, torch.from_numpy(x).double(), spec,
                                head=True, dtype=torch.float64)
    (out * torch.from_numpy(r)).sum().backward()
    params = dict(f64.named_parameters())
    assert set(params) <= set(jgrads)
    top = max(np.abs(jgrads[k].numpy()).max() for k in params)
    for k, p in params.items():
        err = np.abs(p.grad.numpy() - jgrads[k].numpy()).max()
        assert err <= 1e-6 * top, f"grad {k}: {err:.3e}, top {top:.3e}"


def test_bn_eps_and_momentum_follow_the_family():
    """DPN's BNs all at eps 1e-3, the others at torch's 1e-5; momentum 0.1
    everywhere (the JAX package's zoo_train_mode default)."""
    for name, eps in (("dpn68", 1e-3), ("dpn92", 1e-3), ("resnest14d", 1e-5),
                      ("tresnet_m", 1e-5), ("dla34", 1e-5)):
        m = TR.create_model(name, device="cpu").params
        bns = [b for b in m.modules() if isinstance(b, torch.nn.BatchNorm2d)]
        assert bns and {(b.momentum, b.eps) for b in bns} == {(0.1, eps)}
