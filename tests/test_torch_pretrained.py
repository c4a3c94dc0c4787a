"""vitcap_tpu_torch.models.pretrained (save_pretrained / from_pretrained,
reference modeling_utils.py:80-123, :324-533): the cases of
tests/test_pretrained.py in the port, and directories crossing between
the port and the JAX package in both directions (the JAX package's
`model.msgpack` weights included)."""

import json
import os.path as op

import jax
import numpy as np
import pytest
import torch

from vitcap_tpu.models import pretrained as JP
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config

from vitcap_tpu_torch.models import pretrained as P
from vitcap_tpu_torch.models import vitcap as M
from vitcap_tpu_torch.models.config import ModelConfig, tiny_config
from vitcap_tpu_torch.solver import checkpoint_bridge as TB

KW = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config(**KW)
    model = M.init_params(cfg, torch.Generator().manual_seed(7),
                          device="cpu")
    return cfg, model


def _forward(model, cfg):
    rng = np.random.RandomState(0)
    B, T = 2, cfg.max_seq_len
    batch = dict(
        image=torch.from_numpy(rng.randn(B, cfg.img_size, cfg.img_size, 3)
                               .astype(np.float32)),
        input_ids=torch.from_numpy(rng.randint(1, cfg.vocab_size, (B, T))),
        token_type_ids=torch.zeros((B, T), dtype=torch.long),
        seq_a_len=torch.full((B,), cfg.max_seq_a_len),
        seq_len=torch.full((B,), T),
        masked_pos=torch.zeros((B, T), dtype=torch.long),
        masked_ids=torch.zeros((B, cfg.max_masked_tokens), dtype=torch.long),
        label=torch.zeros((B, cfg.tag_vocab_size)))
    batch["masked_pos"][:, 1] = 1
    batch["masked_ids"][:, 0] = 5
    batch["label"][:, 2] = 1.0
    with torch.no_grad():
        total, aux = M.forward_train(model, batch, cfg)
    return total, aux["tag_logits"]


def _params(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def test_roundtrip_exact(tiny, tmp_path):
    cfg, model = tiny
    d = str(tmp_path / "saved")
    P.save_pretrained(d, model, cfg)
    assert op.exists(op.join(d, "config.json"))
    assert op.exists(op.join(d, "pytorch_model.bin"))
    model2, cfg2 = P.from_pretrained(d, device="cpu")
    assert cfg2 == cfg
    a, b = _params(model), _params(model2)
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n
    for x, y in zip(_forward(model, cfg), _forward(model2, cfg2)):
        assert torch.equal(x, y)


def test_config_overrides(tiny, tmp_path):
    cfg, model = tiny
    d = str(tmp_path / "saved")
    P.save_pretrained(d, model, cfg)
    _, cfg2 = P.from_pretrained(d, device="cpu", topk=3)
    assert cfg2.topk == 3
    assert cfg2.hidden_size == cfg.hidden_size
    with pytest.raises(ValueError):
        P.from_pretrained(d, device="cpu", not_a_field=1)


def test_foreign_bertconfig_json():
    """A plain BertConfig json (no vitcap section) still builds a config,
    the reference's VILT-directory path; ModelConfig defaults fill the
    rest, as the JAX package's does."""
    j = {"hidden_size": 32, "num_attention_heads": 2,
         "intermediate_size": 64, "num_hidden_layers": 2,
         "vocab_size": 99, "max_position_embeddings": 40,
         "type_vocab_size": 2, "layer_norm_eps": 1e-5,
         "hidden_dropout_prob": 0.0,
         "attention_probs_dropout_prob": 0.0}
    cfg = P.config_from_json_dict(j, split_blocks=1)
    assert cfg.hidden_size == 32
    assert cfg.bert_layer_norm_eps == 1e-5
    assert cfg.vocab_size == 99
    assert cfg.decoder_layers == ModelConfig().decoder_layers
    assert P.config_to_json_dict(cfg) == JP.config_to_json_dict(
        JP.config_from_json_dict(j, split_blocks=1))


def test_saved_bin_is_module_free_and_reference_named(tiny, tmp_path):
    cfg, model = tiny
    d = str(tmp_path / "saved")
    P.save_pretrained(d, model, cfg, vocab_path=__file__)
    sd = torch.load(op.join(d, "pytorch_model.bin"), weights_only=True)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in sd.values())
    assert any(n.endswith(".weight") for n in sd)
    assert not any(n.startswith("module.") for n in sd)
    assert op.isfile(op.join(d, "vocab.txt"))
    with open(op.join(d, "config.json")) as f:
        j = json.load(f)
    assert j["hidden_size"] == cfg.hidden_size and "vitcap" in j


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_directories_cross_between_the_packages(tmp_path, direction):
    """A directory the port saves loads through the JAX package's
    from_pretrained with equal parameters and config, and the JAX
    package's loads into the port's."""
    d = str(tmp_path / "saved")
    if direction == "port_to_jax":
        cfg = tiny_config(**KW)
        model = M.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
        P.save_pretrained(d, model, cfg)
        jparams, jcfg = JP.from_pretrained(d)
        assert P.config_to_json_dict(cfg) == JP.config_to_json_dict(jcfg)
    else:
        jcfg = jax_tiny_config(**KW)
        jparams = JM.init_params(jax.random.PRNGKey(3), jcfg)
        JP.save_pretrained(d, jparams, jcfg)
        model, cfg = P.from_pretrained(d, device="cpu")
        assert P.config_to_json_dict(cfg) == JP.config_to_json_dict(jcfg)
    got = TB.state_to_jax_flat(dict(model.named_parameters()))
    ref = TB.flatten_params(jax.tree_util.tree_map(np.asarray, jparams))
    assert got.keys() == ref.keys()
    for path, want in ref.items():
        np.testing.assert_array_equal(got[path], want, err_msg=path)


def test_msgpack_weights_load(tmp_path):
    """A directory holding the JAX package's flax msgpack weights
    (`model.msgpack`, as its save_pretrained writes them without torch)
    loads into the port with the JAX package's from_pretrained's
    parameters and config; a directory with neither weights file
    raises."""
    from vitcap_tpu.solver.checkpointing import save_state
    d = tmp_path / "saved"
    d.mkdir()
    jcfg = jax_tiny_config(**KW)
    jparams = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(5), jcfg))
    (d / "config.json").write_text(json.dumps(JP.config_to_json_dict(jcfg)))
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        P.from_pretrained(str(d), device="cpu")
    save_state(str(d / "model.msgpack"), {"params": jparams})
    model, cfg = P.from_pretrained(str(d), device="cpu")
    ref, rcfg = JP.from_pretrained(str(d))
    assert P.config_to_json_dict(cfg) == JP.config_to_json_dict(rcfg)
    got = TB.state_to_jax_flat(dict(model.named_parameters()))
    want = TB.flatten_params(jax.tree_util.tree_map(np.asarray, ref))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
