"""HF-style `save_pretrained` / `from_pretrained` for ViTCAP, the port of
vitcap_tpu/models/pretrained.py (reference ViTCAP
src/layers/bert/modeling_utils.py: PretrainedConfig :80-123,
PreTrainedModel :324-533).

A directory holds `config.json` and `pytorch_model.bin` (and optionally
`vocab.txt`):
- `config.json` carries the BertConfig keys at the top level (the schema
  the pipelines read from `text_encoder_type`) and every ModelConfig field
  under `"vitcap"`, so a directory round-trips exactly and a foreign
  BertConfig `config.json` still builds a config;
- `pytorch_model.bin` is a module-free, reference-named torch state dict
  (the port's parameter names are the reference's), which the JAX
  package's `from_pretrained` and the reference's loaders read;
- loading goes through the `.pt` bridge's dot-suffix matching
  (solver/checkpoint_bridge.py), so `module.` prefixes and foreign layouts
  load as in the reference.
A directory without `pytorch_model.bin` may hold the JAX package's flax
msgpack weights (`model.msgpack`, {'params': the JAX tree}), which load
through the port's own codec (utils/msgpack_state.py), strictly: every
parameter, as the JAX package's from_pretrained maps the tree.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as op
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from .config import ModelConfig

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "pytorch_model.bin"      # reference modeling_utils.py:31
NATIVE_WEIGHTS_NAME = "model.msgpack"   # the JAX package's
VOCAB_NAME = "vocab.txt"


def config_to_json_dict(cfg: ModelConfig) -> Dict[str, Any]:
    """BertConfig keys + a `vitcap` section with every ModelConfig field."""
    return {
        "model_type": "bert",
        "hidden_size": cfg.hidden_size,
        "num_attention_heads": cfg.num_attention_heads,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "layer_norm_eps": cfg.bert_layer_norm_eps,
        "hidden_dropout_prob": cfg.hidden_dropout_prob,
        "attention_probs_dropout_prob": cfg.attention_probs_dropout_prob,
        "vitcap": dataclasses.asdict(cfg),
    }


def config_from_json_dict(j: Dict[str, Any], **overrides) -> ModelConfig:
    """A ModelConfig from the exact `vitcap` section, else from the
    BertConfig keys with ModelConfig defaults for the rest.  `overrides`
    win; an unknown override raises ValueError."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    if "vitcap" in j:
        kw = {k: v for k, v in j["vitcap"].items() if k in fields}
    else:
        kw = {k: v for k, v in j.items() if k in fields}
        if "layer_norm_eps" in j:
            kw["bert_layer_norm_eps"] = j["layer_norm_eps"]
    unknown = set(overrides) - fields
    if unknown:
        raise ValueError(f"unknown ModelConfig overrides: {sorted(unknown)}")
    kw.update(overrides)
    return ModelConfig(**kw)


def save_pretrained(save_directory: str, model: torch.nn.Module,
                    cfg: ModelConfig, vocab_path: Optional[str] = None
                    ) -> None:
    """Write config.json, pytorch_model.bin (the parameters on the CPU, in
    their dtype) and, given vocab_path, a copy of the vocab."""
    os.makedirs(save_directory, exist_ok=True)
    with open(op.join(save_directory, CONFIG_NAME), "w") as f:
        json.dump(config_to_json_dict(cfg), f, indent=2, sort_keys=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(sd, op.join(save_directory, WEIGHTS_NAME))
    if vocab_path:
        shutil.copyfile(vocab_path, op.join(save_directory, VOCAB_NAME))


def from_pretrained(pretrained_dir: str, generator: Optional[
                        torch.Generator] = None, device="cuda",
                    **config_overrides) -> Tuple[torch.nn.Module,
                                                 ModelConfig]:
    """(model, cfg) from a save_pretrained directory, or a config.json
    path beside a pytorch_model.bin (or a model.msgpack).  The model is
    built by init_params from `generator` (default: seed 0) on `device`
    (the card unless asked otherwise), then every parameter whose name a
    state-dict key ends in takes that key's tensor; the rest keep their
    initial values, as the reference's loader does (a model.msgpack must
    cover every parameter).  `config_overrides` update the config before
    the model is built (modeling_utils.py:110-123)."""
    from . import vitcap as M
    from ..solver.checkpoint_bridge import (load_params_from_torch,
                                            load_torch_state_dict)
    if op.isdir(pretrained_dir):
        base = pretrained_dir
        cfg_file = op.join(pretrained_dir, CONFIG_NAME)
    else:
        base, cfg_file = op.dirname(pretrained_dir), pretrained_dir
    with open(cfg_file) as f:
        cfg = config_from_json_dict(json.load(f), **config_overrides)
    bin_path = op.join(base, WEIGHTS_NAME)
    native_path = op.join(base, NATIVE_WEIGHTS_NAME)
    if not op.exists(bin_path) and not op.exists(native_path):
        raise FileNotFoundError(
            f"no {WEIGHTS_NAME} or {NATIVE_WEIGHTS_NAME} in {base}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, generator, device=device)
    if op.exists(bin_path):
        load_params_from_torch(model, load_torch_state_dict(bin_path))
    else:
        from ..solver.checkpointing import load_model_state
        load_params_from_torch(model, load_model_state(native_path, device),
                               strict=True)
    return model, cfg
