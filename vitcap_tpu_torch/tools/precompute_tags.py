"""Offline caption POS-tag precompute, the port of the repository's
tools/precompute_tags.py.

The reference POS-tags every caption with nltk inside the training
loader (reference src/data_layer/dataset.py:774-820: JJ/NN/NNP words feed
the concept-tag multi-hot).  This tool runs it once into a
`<split>.caption_tags.tsv` sidecar that `LoadCaptionTags` and
`CaptionTaggerTensorizer(encode='precomputed')` read
(data/dataset.py, data/tensorizers.py).  Host work only.

Usage:
  python -m vitcap_tpu_torch.tools.precompute_tags --data data/coco \
      --split train [--version N] [--data-root DIR] [--pos JJ,NN,NNP]

Row format: key \\t json [[words of caption 0], [words of caption 1], ...]
(aligned with `<split>.caption.tsv` rows and caption indices).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--version", type=int, default=None)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--pos", default="JJ,NN,NNP",
                    help="POS tags kept (the reference keeps JJ/NN/NNP)")
    args = ap.parse_args(argv)

    from vitcap_tpu_torch.data.tensorizers import pos_tag_caption
    from vitcap_tpu_torch.data.tsv import (TSVDataset, TSVSplitProperty,
                                           tsv_writer)

    keep = set(args.pos.split(","))
    caps = TSVSplitProperty(args.data, args.split, "caption",
                            version=args.version, data_root=args.data_root)

    def rows():
        for i in range(len(caps)):
            key, str_cap = caps[i]
            per_cap = [[w for w, p in pos_tag_caption(c["caption"])
                        if p in keep] for c in json.loads(str_cap)]
            yield key, json.dumps(per_cap)

    # written where TSVSplitProperty(data, split, 'caption_tags', version)
    # resolves
    out = TSVDataset(args.data, args.data_root).get_data(
        args.split, "caption_tags", args.version)
    tsv_writer(rows(), out)
    print(f"wrote {out} ({len(caps)} rows)")
    return out


if __name__ == "__main__":
    main()
