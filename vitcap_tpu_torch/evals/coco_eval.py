"""Caption evaluation glue: prediction TSV + ground-truth -> metric report;
the port's copy of vitcap_tpu/evals/coco_eval.py.

JVM-free equivalent of the reference evaluate_on_coco_caption
(ViTCAP src/tools/captioning/utils_caption_evaluate.py:59-137):
converts the prediction TSV (key, json [{'caption', 'conf'}]) and the
ground-truth caption TSV / COCO json into tokenized maps, runs the native
scorers (evals.metrics via evals.ptb) and writes `<predict>.report` json
with {Bleu_1..4, METEOR, ROUGE_L, CIDEr, SPICE}.

SPICE is the JVM-free SPICE-lite tuple-F1 (evals/spice.py) — it tracks the
Java scorer's ranking, not its absolute values.  On a host without nltk
(METEOR's and SPICE-lite's Porter stemmer) the report leaves both out and
says why under `_impl.not_run`.
"""

from __future__ import annotations

import json
import logging
import os.path as op
from typing import Dict, List, Optional

from ..data.tsv import tsv_reader
from .metrics import compute_all_metrics
from .ptb import ptb_tokenize


def load_predictions(predict_tsv: str) -> Dict[str, List[dict]]:
    res = {}
    for row in tsv_reader(predict_tsv):
        caps = json.loads(row[1])
        if isinstance(caps, dict):
            caps = [caps]
        res[row[0]] = [{"caption": caps[0]["caption"]}]
    return res


def load_gt(gt_file: str) -> Dict[str, List[dict]]:
    """Ground truth from a caption TSV (key, json list) or COCO-format
    json."""
    if gt_file.endswith(".json"):
        coco = json.load(open(gt_file))
        gts: Dict[str, List[dict]] = {}
        for ann in coco["annotations"]:
            gts.setdefault(str(ann["image_id"]), []).append(
                {"caption": ann["caption"]})
        return gts
    return {row[0]: [{"caption": c["caption"]} for c in json.loads(row[1])]
            for row in tsv_reader(gt_file)}


def evaluate_on_coco_caption(predict_tsv: str, gt_file: str,
                             outfile: Optional[str] = None) -> Dict[str, float]:
    res = load_predictions(predict_tsv)
    gts = load_gt(gt_file)
    missing = set(res) - set(gts)
    assert not missing, f"predictions for unknown keys: {sorted(missing)[:5]}"
    gts = {k: gts[k] for k in res}
    gts_tok = ptb_tokenize(gts)
    res_tok = ptb_tokenize(res)
    from .meteor import stemmer_unavailable
    why = stemmer_unavailable()
    if why is not None:
        logging.warning("METEOR and SPICE not run: %s", why)
        result = dict(compute_all_metrics(gts_tok, res_tok, stemmed=False),
                      _impl={"not_run": {"METEOR": why, "SPICE": why}})
        return _write_report(result, predict_tsv, outfile)
    # label the JVM-free reimplementations in the report itself (not just
    # the docs): METEOR uses a compact shipped synonym table instead of
    # WordNet, SPICE is rule-based SPICE-lite — absolute values deviate
    # from the Java tools; BLEU/ROUGE_L/CIDEr are exact reimplementations
    result = dict(compute_all_metrics(gts_tok, res_tok), _impl={
        "METEOR": "native meteor-1.5 (exact/stem/compact-synonym/"
                  "compact-paraphrase; not WordNet-complete)",
        "SPICE": "SPICE-lite (rule-based scene-graph tuple F1, "
                 "stem+compact-synonym matching; not WordNet-complete)"})
    # MEASURED per-axis deviation, not asserted: re-score with each
    # matcher stage off -> band [stage_off, stage_on]; the jar (full
    # WordNet synonyms + the 60MB paraphrase-en.gz table) sits at or
    # above the top of each band on that axis.  Coverage is the fraction
    # of this run's caption content-vocabulary the shipped synonym table
    # can reach — the residual (1-coverage) bounds how much WordNet could
    # still add beyond the measured band width.  The paraphrase axis is
    # METEOR-only (jar SPICE has no paraphrase stage).
    from .meteor import meteor as _meteor, synonym_coverage
    from .spice import spice as _spice
    m_off, _ = _meteor(gts_tok, res_tok, use_synonyms=False)
    s_off, _ = _spice(gts_tok, res_tok, use_synonyms=False)
    m_par_off, _ = _meteor(gts_tok, res_tok, use_paraphrases=False)
    vocab = [w for sents in list(gts_tok.values()) + list(res_tok.values())
             for s in sents for w in s.split()]
    result["_impl"]["synonym_sensitivity"] = {
        "METEOR": [round(m_off, 6), round(result["METEOR"], 6)],
        "SPICE": [round(s_off, 6), round(result["SPICE"], 6)]}
    result["_impl"]["paraphrase_sensitivity"] = {
        "METEOR": [round(m_par_off, 6), round(result["METEOR"], 6)]}
    result["_impl"]["synonym_coverage"] = synonym_coverage(vocab)
    # MEASURED parser gap of SPICE-lite's rule-based chunker vs
    # hand-written gold scene graphs (the jar's dependency parser scores
    # ~1.0 on these by construction) — see spice.parser_deviation.
    # 'dev' is in-sample (the rules' development set); 'heldout' is the
    # out-of-sample bound (25 sentences written after the rules froze).
    from .spice import parser_deviation
    result["_impl"]["spice_parser_deviation"] = parser_deviation("dev")
    result["_impl"]["spice_parser_deviation_heldout"] = \
        parser_deviation("heldout")
    return _write_report(result, predict_tsv, outfile)


def _write_report(result: Dict, predict_tsv: str,
                  outfile: Optional[str]) -> Dict:
    outfile = outfile or op.splitext(predict_tsv)[0] + ".report"
    with open(outfile, "w") as fp:
        json.dump(result, fp, indent=2)
    return result
