"""The port's model zoo, part 2c, its Xceptions (Xception, the aligned
Xception 41 / 65 / 71 and Gluon's Xception-65: vitcap_tpu_torch/models/
xception.py, xception_aligned.py, gluon_xception.py), vs the JAX package's
on the CPU: f32 forwards at real channel widths on 64-px seeded images
(B=2), the feature map and the logits, within 1e-4, the middle flows cut
alike in both packages (XCEPTION_BLOCKS, _blocks_cfg, _BLOCKS); each
family's zoo_params_from_jax key set and a torch state-dict load; and
every registered name's spec, field by field, built and run by
create_model.  The helpers are test_torch_zoo_2c_hrnet.py's.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_2c_xception.py -q
"""

import pytest

from vitcap_tpu.models import gluon_xception as JG
from vitcap_tpu.models import xception as JX
from vitcap_tpu.models import xception_aligned as JXA

from vitcap_tpu_torch.models import gluon_xception as TG
from vitcap_tpu_torch.models import xception as TX
from vitcap_tpu_torch.models import xception_aligned as TXA

from test_torch_zoo_2c_hrnet import (  # noqa: F401 (one_torch_thread)
    check_forward, check_spec_and_build, family_names, loaded_equal,
    one_torch_thread)

FAMILIES = ("XceptionModelSpec", "XcepAlignedModelSpec",
            "GluonXceptionModelSpec")


def cut_middle(monkeypatch, name):
    """One middle-flow block, alike in both packages: Xception's entry
    blocks 1-3, block 4 and the widening block; the aligned nets' entry
    modules, one middle module and the exit; Gluon's blocks 1-3,
    mid.block4 and block20."""
    if name == "xception":
        for mod in (JX, TX):
            t = mod.XCEPTION_BLOCKS
            monkeypatch.setattr(mod, "XCEPTION_BLOCKS", t[:4] + t[-1:])
    elif name.startswith("xception"):
        for mod in (JXA, TXA):
            cfg = mod._blocks_cfg
            n_mid = {"xception41": 8, "xception65": 16, "xception71": 16}

            def cut(variant, cfg=cfg):
                c = cfg(variant)
                return c[:-2 - n_mid[variant] + 1] + c[-2:]
            monkeypatch.setattr(mod, "_blocks_cfg", cut)
    elif name == "gluon_xception65":
        for mod in (JG, TG):
            monkeypatch.setattr(mod, "_BLOCKS",
                                mod._BLOCKS[:4] + mod._BLOCKS[-1:])


# (name, what it covers)
FORWARD_CASES = [
    ("xception", "VALID entry convs, the -inf max pool, grow_first=False, "
                 "the skip before any relu (cut to one middle block)"),
    ("xception41", "BN after the depthwise conv, the stride on the third "
                   "conv, the inner relus of the no-skip module"),
    ("xception65", "the same modules, the entry flow of 3 (cut)"),
    ("xception71", "the entry flow of 5 with its stride-1 modules (cut)"),
    ("gluon_xception65", "the BN between depthwise and pointwise, relu "
                         "after blocks 1 and 20, bn3-bn5 (cut)"),
]


@pytest.mark.parametrize("name", [c[0] for c in FORWARD_CASES])
def test_forward_matches_jax(tmp_path, monkeypatch, name):
    cut_middle(monkeypatch, name)
    check_forward(name, tmp_path)


@pytest.mark.parametrize("name", ["xception", "xception71",
                                  "gluon_xception65"])
def test_torch_checkpoint_load_matches_jax(tmp_path, name):
    """timm's names (block{n}.rep.{i}.{conv1,pointwise} and its BN at i + 1,
    blocks.{i}.stack.conv{k}.{conv_dw,bn_dw,conv_pw,bn_pw}, mid.block{n}
    .rep.conv{k}.{conv_dw,bn,conv_pw}; fc, head.fc) load into equal
    parameters through both packages' loaders, at full depth."""
    loaded_equal(tmp_path, name)


@pytest.mark.parametrize("name", family_names(FAMILIES))
def test_spec_matches_jax_and_builds(name):
    check_spec_and_build(name)
