"""The port's model zoo, part 2a, RegNet, NFNet and BiT ResNetV2
(vitcap_tpu_torch/models/regnet.py, nfnet.py, resnetv2.py), vs the JAX
package's on the CPU: f32 forwards at real channel widths on 64-px seeded
images (B=2), the feature map and the head, within 1e-4; each family's
zoo_params_from_jax key set and a torch state-dict load; and every
registered name's spec, field by field, built and run by create_model.
The helpers (seeded weights carried into the JAX tree through its own
torch loaders) are test_torch_zoo_effnet.py's.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_nets.py -q
"""

import pytest

from vitcap_tpu.models import resnetv2 as JRV2

from test_torch_zoo_effnet import (  # noqa: F401 (one_torch_thread: autouse)
    check_forward, check_spec_and_build, family_names, loaded_equal,
    one_torch_thread, port_and_jax)

FAMILIES = ("RegNetModelSpec", "NfNetModelSpec", "ResNetV2ModelSpec")

# (name, stages kept (0: all), what it covers)
FORWARD_CASES = [
    ("regnetx_002", 0, "grouped 3x3 convs, projections"),
    ("regnety_004", 0, "SE on the block's in width"),
    ("nf_regnet_b0", 0, "ScaledStdConv, silu gamma, SE x2, final conv"),
    ("nf_ecaresnet26", 0, "7x7 + max pool stem, ECA x2, avg-pool "
                          "projections"),
    ("nf_seresnet26", 0, "the resnets' SE"),
    ("resnetv2_50x1_bitm", 2, "BiT: WS convs, GroupNorm, the fixed pool"),
]


@pytest.mark.parametrize("name,stages", [c[:2] for c in FORWARD_CASES],
                         ids=[c[0] for c in FORWARD_CASES])
def test_forward_matches_jax(tmp_path, monkeypatch, name, stages):
    if stages:
        # the JAX package's plan cut to the same first stages
        layers, wf, nc = JRV2.RESNETV2S[name]
        monkeypatch.setitem(JRV2.RESNETV2S, name, (layers[:stages], wf, nc))
    spec, model, jp = port_and_jax(name, tmp_path, n_stages=stages,
                                   num_classes=10)
    check_forward(spec, model, jp)


@pytest.mark.parametrize("name", ["regnety_004", "nf_ecaresnet26",
                                  "resnetv2_50x1_bitm"])
def test_torch_checkpoint_load_matches_jax(tmp_path, name):
    """timm's names (s{k}.b{j}, the NFNet gains and ECA kernels, BiT's 1x1
    conv head) load into equal parameters through both packages'
    loaders."""
    loaded_equal(tmp_path, name, num_classes=10)


@pytest.mark.parametrize("name", family_names(FAMILIES))
def test_spec_matches_jax_and_builds(name):
    check_spec_and_build(name)
