"""The zoo's train mode on part 2c's BatchNorm layouts, the port
(model.train()) vs the JAX package's (zoo_train_mode, bn_updated_params,
jax.grad) on the CPU, seeded images, B=2, at real channel widths (none of
these families has a head dropout or a drop path: train mode is BatchNorm
on batch statistics):

HRNet's biased downsample convs before their BN and its upsample,
Inception-V3's eps 1e-3 BasicConv2d, Xception's BN after the pointwise
conv and its skip BN, the aligned Xception's BN after the depthwise conv,
Gluon's BN between depthwise and pointwise (and, by check_train in
test_torch_zoo_2c_nas.py, NASNet's BN on the factorised reduction's
concatenation and PNASNet's cells): the train-mode logits and
every updated running statistic, each within 1e-6 of its tensor's largest
magnitude, and for hrnet_w18_small, inception_v3 and gluon_xception65
(cut) every parameter's gradient (of sum(logits * r), r seeded) within
1e-6 of the model's largest gradient.  All in f64, the JAX side under
jax.enable_x64 with its modules' float32 read as float64 (as in
test_torch_zoo_train.py): a train BatchNorm over B=2 images, on maps down
to 1 x 1, is so ill-conditioned that either package's f32 forward strays
from its own f64 one past 1e-4 of the logits' scale (Inception-V3 at 75
px, NASNet, PNASNet).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_2c_train.py -q
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import backbones as JB
from vitcap_tpu.models import layers as JL
from vitcap_tpu.models import registry as JR

from vitcap_tpu_torch.models import registry as TR

from test_torch_zoo_2c_hrnet import (  # noqa: F401 (one_torch_thread)
    _np_tree, cut_hrnet, family, imgs, jax_spec, one_torch_thread,
    port_and_jax)
from test_torch_zoo_2c_xception import cut_middle
from test_torch_zoo_train import _Wide, _close_to_scale

# (name, image size, f64 gradients, what its train mode covers)
TRAIN_CASES = [
    ("hrnet_w18_small", 64, True, "conv bias before BN, the upsample"),
    ("inception_v3", 75, True, "BasicConv2d's eps 1e-3, 1x1 maps"),
    ("xception", 64, False, "BN after the pointwise conv, the skip BN"),
    ("xception41", 64, False, "BN after the depthwise conv, inner relus"),
    ("gluon_xception65", 64, True, "BN between depthwise and pointwise"),
]  # the NAS nets' cases are in test_torch_zoo_2c_nas.py
TOL = 1e-6     # of the compared tensor's (the gradients': the model's)
               # largest magnitude, in f64


@pytest.mark.parametrize("name, size, grads",
                         [c[:3] for c in TRAIN_CASES])
def test_train_forward_stats_and_grads_match_jax(tmp_path, monkeypatch,
                                                 name, size, grads):
    check_train(tmp_path, monkeypatch, name, size, grads)


def check_train(tmp_path, monkeypatch, name, size, grads):
    """The port's f64 train-mode logits and running statistics (and with
    `grads` its gradients) against the JAX package's, within TOL."""
    cut_hrnet(monkeypatch, name)
    cut_middle(monkeypatch, name)
    spec, model, jp = port_and_jax(name, tmp_path, size, seed=5,
                                   calibrate=False, num_classes=10)
    jspec = jax_spec(spec)
    jfwd = getattr(JR, f"{family(spec)}_forward")
    x = imgs(size) * 0.5
    r = np.random.RandomState(1).randn(2, 10)

    def jax_train(p, a):
        with JB.zoo_train_mode() as tm:
            logits = jfwd(p, a, jspec, head=True, dtype=jnp.float64)
            new = JB.bn_updated_params(p, tm)
        return jnp.sum(logits * r), (logits, new)

    jfam = importlib.import_module(f"vitcap_tpu.models.{family(spec)}")
    for mod in (JB, JL, JR, jfam):
        monkeypatch.setattr(mod, "jnp", _Wide())
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), jp)
        a64 = jnp.asarray(x, jnp.float64)
        if grads:
            jgrads, (want, new) = jax.jit(jax.grad(jax_train, has_aux=True))(
                jp64, a64)
            jgrads = TR.zoo_params_from_jax(_np_tree(jgrads), spec)
        else:
            _, (want, new) = jax.jit(jax_train)(jp64, a64)
        want, new = np.asarray(want), _np_tree(new)
    f64 = copy.deepcopy(model).double().requires_grad_(grads).train()
    out = TR.pooled_cnn_forward(f64, torch.from_numpy(x).double(), spec,
                                head=True, dtype=torch.float64)
    _close_to_scale(out.detach().numpy(), want, "logits", TOL)
    sd = f64.state_dict()
    running = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    stats = TR.zoo_params_from_jax(new, spec)
    old = TR.zoo_params_from_jax(_np_tree(jp), spec)
    assert running and set(running) <= set(stats)
    for k in running:
        _close_to_scale(sd[k].numpy(), stats[k].numpy(), k, TOL)
        assert not np.allclose(sd[k].numpy(), old[k].numpy()), k
    if not grads:
        return
    (out * torch.from_numpy(r)).sum().backward()
    params = dict(f64.named_parameters())
    assert set(params) <= set(jgrads)
    top = max(np.abs(jgrads[k].numpy()).max() for k in params)
    for k, p in params.items():
        err = np.abs(p.grad.numpy() - jgrads[k].numpy()).max()
        assert err <= TOL * top, f"grad {k}: {err:.3e}, top {top:.3e}"


def test_bn_eps_and_momentum_follow_the_family():
    """BN eps 1e-3 in the inceptions, the aligned Xceptions and the NAS
    nets, torch's 1e-5 in HRNet and the other Xceptions; momentum 0.1
    everywhere (the JAX package's zoo_train_mode default)."""
    for name, eps in (("inception_v3", 1e-3), ("inception_v4", 1e-3),
                      ("inception_resnet_v2", 1e-3), ("xception41", 1e-3),
                      ("nasnetalarge", 1e-3), ("pnasnet5large", 1e-3),
                      ("hrnet_w18_small", 1e-5), ("xception", 1e-5),
                      ("gluon_xception65", 1e-5)):
        m = TR.create_model(name, device="cpu").params
        bns = [b for b in m.modules() if isinstance(b, torch.nn.BatchNorm2d)]
        assert bns and {(b.momentum, b.eps) for b in bns} == {(0.1, eps)}
