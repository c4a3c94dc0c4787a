"""nocaps submission-file preparation; the port's copy of
vitcap_tpu/evals/nocaps.py.

The reference NocapsEvaluator (utils_caption_evaluate.py:244-380) uploads
predictions to EvalAI over the network; this module covers the local
half: converting a prediction TSV into the
nocaps/EvalAI submission json ([{image_id, caption}]) keyed either by
integer ids or by an id mapping."""

from __future__ import annotations

import json
from typing import Dict, Optional

from ..data.tsv import tsv_reader


def prediction_tsv_to_nocaps_json(predict_tsv: str, out_json: str,
                                  key_to_image_id: Optional[Dict] = None
                                  ) -> str:
    preds = []
    for row in tsv_reader(predict_tsv):
        caps = json.loads(row[1])
        if isinstance(caps, dict):
            caps = [caps]
        image_id = key_to_image_id[row[0]] if key_to_image_id else row[0]
        try:
            image_id = int(image_id)
        except (TypeError, ValueError):
            pass
        preds.append({"image_id": image_id,
                      "caption": caps[0]["caption"]})
    with open(out_json, "w") as f:
        json.dump(preds, f)
    return out_json
