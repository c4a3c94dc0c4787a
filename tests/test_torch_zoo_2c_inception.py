"""The port's model zoo, part 2c, its inceptions (Inception-V3, V4 and
Inception-ResNet-V2: vitcap_tpu_torch/models/inception_v3.py,
inception_v4.py, inception_resnet_v2.py), vs the JAX package's on the CPU:
f32 forwards of the whole nets at real channel widths on seeded images
(B=2) of 75 px or more (their VALID stride-2 reductions leave no map
below 75), the feature map and the logits, within 1e-4; each family's
zoo_params_from_jax key set and a torch state-dict load; and every
registered name's spec, field by field, built and run by create_model.
The helpers are test_torch_zoo_2c_hrnet.py's.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_2c_inception.py -q
"""

import numpy as np
import pytest
import torch

from vitcap_tpu_torch.models import inception_v3 as TI3
from vitcap_tpu_torch.models import inception_v4 as TI4

from test_torch_zoo_2c_hrnet import (  # noqa: F401 (one_torch_thread)
    check_forward, check_spec_and_build, family_names, loaded_equal,
    one_torch_thread)

FAMILIES = ("InceptionV3ModelSpec", "InceptionV4ModelSpec",
            "InceptionResnetV2ModelSpec")

# (name, image size, what it covers)
FORWARD_CASES = [
    ("inception_v3", 75, "blocks A-E at the smallest map, the avg-pool "
                         "branch counting its padding"),
    ("tf_inception_v3", 99, "the same graph under another name, at a size "
                            "whose reductions floor"),
    ("inception_v4", 75, "the stem's concatenating reductions, the "
                         "avg-pool branch excluding its padding"),
    ("inception_resnet_v2", 75, "the scaled residuals, the biased conv2d, "
                                "the last Block8 without its relu"),
]


@pytest.mark.parametrize("name, size", [c[:2] for c in FORWARD_CASES])
def test_forward_matches_jax(tmp_path, name, size):
    check_forward(name, tmp_path, size)


@pytest.mark.parametrize("name", ["inception_v3", "inception_v4",
                                  "ens_adv_inception_resnet_v2"])
def test_torch_checkpoint_load_matches_jax(tmp_path, name):
    """timm's names (Mixed_6b.branch7x7_2.{conv,bn}, features.{i} with
    branch{k}.{j}, repeat_1.{i}.conv2d with its bias; fc, last_linear,
    classif) load into equal parameters through both packages' loaders."""
    loaded_equal(tmp_path, name)


def test_avg_pools_count_the_padding_as_each_net_does():
    """Inception-V3's branch pool divides by 9 at the border too, V4's by
    the window's valid count."""
    x = torch.ones(1, 1, 4, 4)
    corner_v3 = torch.nn.functional.avg_pool2d(x, 3, 1, 1)[0, 0, 0, 0]
    assert corner_v3.item() == pytest.approx(4 / 9)
    np.testing.assert_array_equal(TI4._avg3_excl(x).numpy(), x.numpy())
    assert TI3._max32(torch.zeros(1, 1, 75, 75)).shape[-1] == 37


@pytest.mark.parametrize("name", family_names(FAMILIES))
def test_spec_matches_jax_and_builds(name):
    check_spec_and_build(name, size=75)
