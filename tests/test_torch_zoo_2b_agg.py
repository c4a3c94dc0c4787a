"""The port's model zoo, part 2b, its aggregating families (CSPNet /
DarkNet, DPN, DenseNet, DLA and VoVNet: vitcap_tpu_torch/models/
cspnet.py, dpn.py, densenet.py, dla.py, vovnet.py), vs the JAX package's
on the CPU: f32 forwards at real channel widths on 64-px seeded images
(B=2), the feature map and the logits, within 1e-4, one case a distinct
block path; each family's zoo_params_from_jax key set and a torch
state-dict load; and every registered name's spec, field by field, built
and run by create_model.  The helpers are test_torch_zoo_2b_res.py's.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_2b_agg.py -q
"""

import pytest

from vitcap_tpu.models import densenet as JDN
from vitcap_tpu.models import vovnet as JVV

from vitcap_tpu_torch.models import densenet as TDN
from vitcap_tpu_torch.models import vovnet as TVV

from test_torch_zoo_2b_res import (  # noqa: F401 (one_torch_thread: autouse)
    check_forward, check_spec_and_build, cut_blocks, family_names,
    loaded_equal, one_torch_thread)

FAMILIES = ("CspNetModelSpec", "DpnModelSpec", "DenseNetModelSpec",
            "DlaModelSpec", "VovNetModelSpec")

# both packages' tables cut alike where a whole net costs more than a few
# seconds: name -> (JAX module, port module, table, cut)
CUTS = {
    "densenet264d_iabn": (JDN, TDN, "DENSENETS",
                          lambda c: (c[0], (2, 3, 4, 3), c[2])),
    "ese_vovnet99b_iabn": (JVV, TVV, "VOVNETS",
                           lambda c: dict(c, bps=(1, 2, 2, 1))),
}

# (name, what it covers)
FORWARD_CASES = [
    ("cspresnet50", "7x7 stem + pool, cross stage, linear conv_exp"),
    ("cspresnet50d", "the deep stem"),
    ("cspresnext50", "grouped conv_down and bottleneck 3x3"),
    ("cspdarknet53", "dark blocks in cross stages, down_growth, no pool"),
    ("darknet53", "dark stages without the cross split"),
    ("dpn68", "3x3 stem, dual path: residual add and dense concat"),
    ("dpn68b", "the b blocks: BN + act, then the c1 / c2 convs"),
    ("dpn92", "7x7 stem, bottleneck width factor 4"),
    ("densenet121", "dense layers, transitions, norm5"),
    ("densenetblur121d", "deep stem, stride-1 max pool + blur pool"),
    ("densenet264d_iabn", "InplaceABN: leaky relu everywhere (2-4 layers "
                          "a block)"),
    ("dla34", "basic blocks, the tree, level-root children"),
    ("dla46x_c", "grouped bottleneck at the c widths"),
    ("dla60_res2net", "bottle2neck at scale 4, the avd pool"),
    ("dla60_res2next", "bottle2neck with cardinality 8"),
    ("dla102x", "two- and three-level trees, the root residual"),
    ("ese_vovnet19b_dw", "separable stem and OSA convs, conv_reduction, "
                         "ESE"),
    ("ese_vovnet19b_slim_dw", "the slim dw widths"),
    ("vovnet39a", "v1: no residual, no attention, ceil-mode pool"),
    ("eca_vovnet39b", "ECA's conv1d, the v2 residual"),
    ("ese_vovnet39b_evos", "EvoNorm-S0 for every BN + act"),
    ("ese_vovnet99b_iabn", "InplaceABN's leaky relu (1-2 blocks a stage)"),
]


def _cut(monkeypatch, name):
    if name in CUTS:
        jm, tm, table, cut = CUTS[name]
        cut_blocks(monkeypatch, (jm, tm), table, name, cut)


@pytest.mark.parametrize("name", [c[0] for c in FORWARD_CASES])
def test_forward_matches_jax(tmp_path, monkeypatch, name):
    _cut(monkeypatch, name)
    check_forward(name, tmp_path)


@pytest.mark.parametrize("name", ["cspdarknet53", "dpn68b", "tv_densenet121",
                                  "dla60_res2next", "ese_vovnet39b_evos"])
def test_torch_checkpoint_load_matches_jax(tmp_path, monkeypatch, name):
    """timm's names (stages.{i}.conv_exp, features.conv{s}_{i} with the
    c1x1_c1 / c2 convs and the 1x1-conv classifier, denseblock /
    denselayer, the recursive level trees, EvoNorm's (1, C, 1, 1) weight,
    bias and v) load into equal parameters through both packages'
    loaders."""
    _cut(monkeypatch, name)
    loaded_equal(tmp_path, name)


@pytest.mark.parametrize("name", family_names(FAMILIES))
def test_spec_matches_jax_and_builds(name):
    check_spec_and_build(name)
