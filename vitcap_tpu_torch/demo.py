"""Single-image captioning demo, the port of the repository's demo.py (the
reference `Loading Script.ipynb` path).

Usage:
  python -m vitcap_tpu_torch.demo --checkpoint ckpt.pt|ckpt.ckpt|ckpt.orbax \
      --image photo.jpg [--encoder-dir DIR] [--beams 1] [--device cuda]

Loads the model (a reference `.pt` through the checkpoint bridge, or a
snapshot of any format: the port's torch.save, the JAX package's msgpack
`.ckpt` or its orbax `.orbax` directory), runs the test image transform (PIL), and greedy- or
beam-decodes one caption with its predicted concept tags, on the card
unless --device says otherwise (cuda without a card raises).
"""

from __future__ import annotations

import argparse
import json
import os.path as op
from typing import Any, Dict

from vitcap_tpu_torch.utils.common import asset_path


def device_of(name: str):
    """torch.device(name); a CUDA device without a card raises."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device (pass "
                           f"--device cpu to run on the CPU)")
    return dev


def encoder_config(encoder_dir: str, crop_size: int, **kw):
    """The ModelConfig both demos build from the encoder's BertConfig
    json, dropout off."""
    from vitcap_tpu_torch.models.config import ModelConfig
    with open(op.join(encoder_dir, "config.json")) as f:
        j = json.load(f)
    return ModelConfig(
        hidden_size=j["hidden_size"],
        num_attention_heads=j["num_attention_heads"],
        intermediate_size=j["intermediate_size"],
        num_hidden_layers=j["num_hidden_layers"],
        vocab_size=j["vocab_size"], tag_vocab_size=j["vocab_size"],
        max_position_embeddings=j["max_position_embeddings"],
        img_size=crop_size,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **kw)


def load_weights(model, checkpoint: str):
    """A reference `.pt`/`.pth` through the bridge (missing names keep
    their initial values; its report returned), else a snapshot of any
    format, strictly (None returned)."""
    if checkpoint.endswith((".pt", ".pth")):
        from vitcap_tpu_torch.solver.checkpoint_bridge import (
            load_params_from_torch, load_torch_state_dict)
        return load_params_from_torch(
            model, load_torch_state_dict(checkpoint))[1]
    from vitcap_tpu_torch.solver.checkpointing import load_model_state
    dev = next(model.parameters()).device
    model.load_state_dict(load_model_state(checkpoint, dev), strict=True)
    return None


def load_image(path: str, crop_size: int, dev):
    """(1, crop, crop, 3) f32 on `dev`: the test transform, PIL route."""
    import torch
    from PIL import Image
    from vitcap_tpu_torch.data.transforms import TestImageTransform
    img = Image.open(path).convert("RGB")
    x = TestImageTransform(crop_size=crop_size, backend="pil")(img)[None]
    return torch.from_numpy(x).to(dev)


def caption(model, cfg, tokenizer, image, beams: int = 1,
            topk_tags: int = 20) -> Dict[str, Any]:
    """One image through models.decode.generate: the top beam's caption,
    confidence and top tags."""
    import numpy as np
    import torch
    from vitcap_tpu_torch.models import decode as D
    dev = image.device
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    opts = D.DecodeOptions(max_length=cfg.max_gen_length, num_beams=beams,
                           od_labels_start_posid=cfg.max_seq_a_len)
    with torch.inference_mode():
        out = D.generate(model, image,
                         torch.zeros((1, od_len), dtype=torch.long,
                                     device=dev), None,
                         torch.full((1,), cfg.max_seq_a_len, device=dev),
                         cfg, opts)
    ids = out["ids"][0, 0].cpu().numpy()
    tags = (tokenizer.convert_ids_to_tokens(
        out["pred_topk"][0][:topk_tags].cpu().tolist())
        if "pred_topk" in out else [])
    return {"caption": tokenizer.decode(ids.tolist(),
                                        skip_special_tokens=True),
            "conf": float(np.exp(out["logprobs"][0, 0].float().item())),
            "tags": tags}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--image", required=True)
    ap.add_argument("--encoder-dir",
                    default=asset_path("VILT-L12-H784-uncased_16_384"))
    ap.add_argument("--beams", type=int, default=1)
    ap.add_argument("--crop-size", type=int, default=384)
    ap.add_argument("--topk-tags", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from vitcap_tpu_torch.data.tokenization import BertTokenizer
    from vitcap_tpu_torch.models import vitcap as M

    dev = device_of(args.device)
    cfg = encoder_config(args.encoder_dir, args.crop_size)
    tokenizer = BertTokenizer(op.join(args.encoder_dir, "vocab.txt"))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    report = load_weights(model, args.checkpoint)
    if report is not None:
        print(f"loaded {len(report['matched'])} tensors from torch ckpt "
              f"({len(report['missing'])} missing, "
              f"{len(report['shape_mismatch'])} shape-skipped)")
    out = caption(model, cfg, tokenizer,
                  load_image(args.image, args.crop_size, dev), args.beams,
                  args.topk_tags)
    print(f"caption: {out['caption']!r}  (conf {out['conf']:.3f})")
    print(f"top tags: {out['tags']}")
    return out["caption"]


if __name__ == "__main__":
    main()
