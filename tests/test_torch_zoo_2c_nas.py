"""The port's model zoo, part 2c, its NAS nets (NASNet-A-Large and
PNASNet-5-Large: vitcap_tpu_torch/models/nasnet.py, pnasnet.py), vs the
JAX package's on the CPU: f32 forwards of the whole nets (every cell of
NASNET_CELLS / PNASNET_CELLS) at real channel widths on 64-px seeded
images (B=2), the feature map and the logits, within 1e-4; each family's
zoo_params_from_jax key set and a torch state-dict load; their train
mode in f64 (test_torch_zoo_2c_train.py's check); both specs, field by
field, built and run by create_model; the two avg pools and the
factorised reduction's shift.  The helpers are
test_torch_zoo_2c_hrnet.py's.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_2c_nas.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import nasnet as JN

from vitcap_tpu_torch.models import nasnet as TN
from vitcap_tpu_torch.models import registry as TR

from test_torch_zoo_2c_hrnet import (  # noqa: F401 (one_torch_thread)
    CONV_TOL, check_forward, check_spec_and_build, family_names,
    loaded_equal, one_torch_thread)
from test_torch_zoo_2c_train import check_train

FAMILIES = ("NASNetModelSpec", "PNASNetModelSpec")

# (name, what it covers)
FORWARD_CASES = [
    ("nasnetalarge", "TF-'SAME' separables, both avg pools, the "
                     "factorised reduction, the first cells' prev-prev "
                     "skip over a reduction"),
    ("pnasnet5large", "the VALID conv_0, comb 3 on comb 2's output, the "
                      "stem's pool-conv comb, ActConvBn on a reduction's "
                      "comb 4"),
]


@pytest.mark.parametrize("name", [c[0] for c in FORWARD_CASES])
def test_forward_matches_jax(tmp_path, name):
    check_forward(name, tmp_path)


@pytest.mark.parametrize("name", [c[0] for c in FORWARD_CASES])
def test_torch_checkpoint_load_matches_jax(tmp_path, name):
    """timm's names (comb_iter_{k}_{left,right}.separable_{1,2}
    .{depthwise,pointwise}_conv2d and .bn_sep_{1,2}, path_{1,2}.conv and
    final_path_bn on a cell or under conv_prev_1x1, last_linear) load into
    equal parameters through both packages' loaders."""
    loaded_equal(tmp_path, name)


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
def test_avg_pool_and_fact_reduce_match_jax(size, stride):
    """The avg pool's two meanings and the shifted path of the factorised
    reduction, at an odd and an even size."""
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(
        np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = TN.avg_pool_same(t, stride).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JN._avg_pool_same(jnp.asarray(x), stride))
    np.testing.assert_allclose(got, want, **CONV_TOL)
    got = TN.max_pool_same(t, stride).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JN._max_pool_same(jnp.asarray(x), stride))
    np.testing.assert_array_equal(got, want)
    r = np.random.RandomState(stride)
    jp = {"conv1": r.randn(1, 1, 3, 2).astype(np.float32),
          "conv2": r.randn(1, 1, 3, 2).astype(np.float32),
          "bn": {k: (1.0 + 0.1 * r.rand(4) if k == "var" else
                     0.1 * r.randn(4)).astype(np.float32)
                 for k in ("scale", "bias", "mean", "var")}}
    m = TR.load_zoo_state(TN._Group(**TN.path_p(3, 4, "cpu")), {
        k[2:]: v for k, v in TN.path_from_jax(jp, "m").items()})
    with torch.no_grad():
        got = TN.fact_reduce(t, m.eval()).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JN._fact_reduce(jnp.asarray(x), jp))
    np.testing.assert_allclose(got, want, **CONV_TOL)


@pytest.mark.parametrize("name", [c[0] for c in FORWARD_CASES])
def test_train_forward_and_stats_match_jax(tmp_path, monkeypatch, name):
    """test_torch_zoo_2c_train.py's f64 train-mode check (no gradients):
    NASNet's BN on the factorised reduction's concatenation, PNASNet's
    pool-conv BN and ActConvBn combs."""
    check_train(tmp_path, monkeypatch, name, 64, grads=False)


@pytest.mark.parametrize("name", family_names(FAMILIES))
def test_spec_matches_jax_and_builds(name):
    check_spec_and_build(name)
