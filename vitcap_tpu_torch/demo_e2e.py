"""End-to-end captioning demo, detections -> constrained decode: the port
of the repository's demo_e2e.py.

The reference's captioning_e2e.py chains an external maskrcnn detector
with the captioner: detected boxes and labels become od-label text plus
CBS constraint words.  This demo keeps that seam but takes the detector's
output as data (a detections JSON from any detector) or, detector-free,
uses the model's own predicted concept tags as constraints.

Usage:
  python -m vitcap_tpu_torch.demo_e2e --checkpoint ckpt.pt --image a.jpg \
      [--detections det.json] [--beams 5] [--min-constraints 2] \
      [--hierarchy hierarchy.json] [--wordforms wordforms.tsv] \
      [--device cuda]

det.json: {"detections": [{"class": "dog", "conf": 0.97,
                           "rect": [x1, y1, x2, y2]}, ...]}
"""

from __future__ import annotations

import argparse
import json
import os.path as op
from typing import Any, Dict, List

import numpy as np

from vitcap_tpu_torch.utils.common import asset_path


def load_model(checkpoint: str, encoder_dir: str, crop_size: int, dev):
    """(model, cfg, tokenizer): the encoder's config with up to 4 tag
    blocks, weights from a `.pt` or a snapshot of any format."""
    import torch
    from vitcap_tpu_torch.data.tokenization import BertTokenizer
    from vitcap_tpu_torch.demo import encoder_config, load_weights
    from vitcap_tpu_torch.models import vitcap as M
    with open(op.join(encoder_dir, "config.json")) as f:
        layers = json.load(f)["num_hidden_layers"]
    cfg = encoder_config(encoder_dir, crop_size,
                         split_blocks=min(4, layers))
    tokenizer = BertTokenizer(op.join(encoder_dir, "vocab.txt"))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    load_weights(model, checkpoint)
    return model.requires_grad_(False), cfg, tokenizer


class _NoHierarchyFilter:
    """ConstraintFilter fallback without the Open-Images hierarchy json:
    blacklist + confidence sort + dedup (no NMS)."""

    def __init__(self, max_given_constraints: int = 3):
        self._max = max_given_constraints

    def __call__(self, boxes, class_names, scores):
        from vitcap_tpu_torch.models.cbs import BLACKLIST, REPLACEMENTS
        pairs = [(c, s) for c, s in zip(class_names, scores)
                 if s > 0 and c not in BLACKLIST]
        pairs.sort(key=lambda t: -t[1])
        # dedup before truncating (as ConstraintFilter's NMS does) so
        # duplicate detections do not take constraint slots
        names = list(dict.fromkeys(REPLACEMENTS.get(c, c) for c, _ in pairs))
        return names[: self._max]


def constraints_for(model, cfg, tokenizer, x, detections, hierarchy,
                    max_constraints: int):
    """(constraint words, od-label token ids): from a detections file
    (its classes also the od-label text), else the model's top tags."""
    from vitcap_tpu_torch.models import cbs as C
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    if detections:
        with open(detections) as f:
            det = json.load(f)["detections"]
        boxes = np.array([d.get("rect", [0, 0, 1, 1]) for d in det],
                         np.float32).reshape(-1, 4)
        names = [d["class"].lower() for d in det]
        scores = np.array([d.get("conf", 1.0) for d in det], np.float32)
        if hierarchy:
            filt = C.ConstraintFilter(hierarchy,
                                      max_given_constraints=max_constraints)
        else:
            filt = _NoHierarchyFilter(max_constraints)
        constraints = filt(boxes, names, scores)
        # detected classes also serve as od-label text (the reference's
        # IdentifyTextAB path)
        od_tokens: List[str] = []
        for n in sorted(set(names)):
            od_tokens += tokenizer.tokenize(n)
        return constraints, tokenizer.convert_tokens_to_ids(
            od_tokens[:od_len])
    from vitcap_tpu_torch.models import vitcap as M
    top = M.encode_images(model, x, cfg)["pred_topk"][0][:8].cpu().tolist()
    words = [w for w in tokenizer.convert_ids_to_tokens(top)
             if w.isalpha() and len(w) > 2]
    return words[:max_constraints], []


def constrained_caption(model, cfg, tokenizer, x, constraints, od_id_list,
                        wordforms_tsv, beams: int, max_constraints: int,
                        min_constraints: int) -> Dict[str, Any]:
    """The FSM of `constraints`, models.cbs.constrained_beam_search (the
    dense search, as the JAX package's demo runs) and the best beam that
    meets min_constraints: its caption and length-normalised
    log-probability."""
    import torch
    from vitcap_tpu_torch.models import cbs as C
    from vitcap_tpu_torch.models import decode as D
    dev = x.device
    if wordforms_tsv:
        wordforms = C.load_wordforms(wordforms_tsv)
    else:
        wordforms = {c: sorted({c, c + "s"}) for c in constraints}
    c2t = {c: tokenizer.tokenize(c) or [c] for c in constraints}
    builder = C.FiniteStateMachineBuilder(
        tokenizer, c2t, wordforms, max_given_constraints=max_constraints)
    fsm, _ = builder.build(constraints)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    od_ids = torch.zeros((1, od_len), dtype=torch.long, device=dev)
    od_ids[0, :len(od_id_list)] = torch.tensor(od_id_list, dtype=torch.long)
    seq_len = torch.full((1,), cfg.max_seq_a_len + len(od_id_list),
                         device=dev)
    opts = D.DecodeOptions(max_length=cfg.max_gen_length,
                           od_labels_start_posid=cfg.max_seq_a_len)
    out = C.constrained_beam_search(
        model, x, od_ids, None, seq_len,
        torch.from_numpy(np.asarray(fsm)[None]).to(dev), cfg, opts,
        beam_size=beams)
    best, lp = C.select_best_beam_with_constraints(
        out["ids"][:, :, :, 1:].cpu().numpy(),
        out["logprobs"].float().cpu().numpy(),
        np.asarray([len(constraints)]), min_constraints,
        [cfg.sep_token_id])
    return {"caption": tokenizer.decode(best[0].tolist(),
                                        skip_special_tokens=True),
            "logprob": float(lp[0])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--image", required=True)
    ap.add_argument("--detections", default=None,
                    help="detector-output json; omitted = use predicted "
                         "concept tags as constraints")
    ap.add_argument("--encoder-dir",
                    default=asset_path("VILT-L12-H784-uncased_16_384"))
    ap.add_argument("--hierarchy", default=None,
                    help="Open-Images hierarchy json for constraint NMS")
    ap.add_argument("--wordforms", default=None,
                    help="constraint wordforms tsv (word\\tforms,comma,sep)")
    ap.add_argument("--beams", type=int, default=5)
    ap.add_argument("--max-constraints", type=int, default=3)
    ap.add_argument("--min-constraints", type=int, default=2)
    ap.add_argument("--crop-size", type=int, default=384)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vitcap_tpu_torch.demo import device_of, load_image
    dev = device_of(args.device)
    model, cfg, tokenizer = load_model(args.checkpoint, args.encoder_dir,
                                       args.crop_size, dev)
    x = load_image(args.image, args.crop_size, dev)
    constraints, od_id_list = constraints_for(
        model, cfg, tokenizer, x, args.detections, args.hierarchy,
        args.max_constraints)
    print(f"constraints: {constraints}")
    out = constrained_caption(model, cfg, tokenizer, x, constraints,
                              od_id_list, args.wordforms, args.beams,
                              args.max_constraints, args.min_constraints)
    print(f"caption: {out['caption']!r}  (logprob {out['logprob']:.3f})")
    return out["caption"]


if __name__ == "__main__":
    main()
