"""vitcap_tpu_torch's caption evaluation against the JAX package's, on the
same captions: the PTB tokenizer, BLEU-1..4, ROUGE-L, CIDEr (and the
CIDEr-D scorer SCST uses, with a document-frequency pickle), METEOR and
SPICE-lite with their sensitivity bands and the parser deviation, every
score within 1e-12; evaluate_on_coco_caption's `.report` within 1e-12;
the nocaps submission json; and the report on a host without nltk, which
leaves METEOR and SPICE out and says why.

Both packages score corpus CIDEr-D with their native C++ scorers unless
VITCAP_NATIVE_CIDER=0: both sides run their Python paths here, and
test_cider_matches_the_native_scorer holds the port's C++ scorer to the
JAX package's (tests/test_torch_host_native.py holds it to the Python
one at the last bits of f64 sums in another order).
"""

import json
import pickle
from collections import defaultdict

import numpy as np
import pytest

from vitcap_tpu.evals import coco_eval as JE
from vitcap_tpu.evals import meteor as JMt
from vitcap_tpu.evals import metrics as JM
from vitcap_tpu.evals import nocaps as JN
from vitcap_tpu.evals import ptb as JP
from vitcap_tpu.evals import spice as JS

from vitcap_tpu_torch.data.tsv import tsv_writer
from vitcap_tpu_torch.evals import coco_eval as TE
from vitcap_tpu_torch.evals import meteor as TMt
from vitcap_tpu_torch.evals import metrics as TM
from vitcap_tpu_torch.evals import nocaps as TN
from vitcap_tpu_torch.evals import ptb as TP
from vitcap_tpu_torch.evals import spice as TS

RAW_GTS = {
    "a": ["A dog runs across the field.", "The brown dog runs through a "
          "grassy field!", "a puppy is running on the grass"],
    "b": ["A man rides a bicycle down the street.", "The man is riding "
          "his bike on the road", "a person cycling next to parked cars"],
    "c": ["Two cats are sleeping on the couch.", "cats sleep on a sofa",
          "two kittens curled up together on a red sofa"],
    "d": ["A woman holding an umbrella in the rain.", "A lady with a "
          "black umbrella walks down a wet street", "someone can't find "
          "shelter from the storm"],
}
RAW_RES = {"a": ["A dog running across the grassy field."],
           "b": ["a man riding a bike down the road"],
           "c": ["two cats sleep on the couch"],
           "d": ["a woman walks with an umbrella in the rain"]}


@pytest.fixture(autouse=True)
def _python_cider(monkeypatch):
    monkeypatch.setenv("VITCAP_NATIVE_CIDER", "0")


def _tok(mod):
    return (mod.ptb_tokenize({k: [{"caption": c} for c in v]
                              for k, v in RAW_GTS.items()}),
            mod.ptb_tokenize({k: [{"caption": c} for c in v]
                              for k, v in RAW_RES.items()}))


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=0, atol=tol)


def test_ptb_tokenize_matches_jax():
    assert _tok(TP) == _tok(JP)
    for s in ("He said \"don't\" -- it's gonna rain...", "cannot GIMME "
              "that; 3.5-inch rock'n'roll!"):
        assert TP.ptb_tokenize_sentence(s) == JP.ptb_tokenize_sentence(s)


@pytest.mark.parametrize("metric", ["bleu", "rouge_l", "cider", "meteor"])
def test_metric_matches_jax(metric):
    gts, res = _tok(TP)
    got, want = getattr(TM, metric)(gts, res), getattr(JM, metric)(gts, res)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_spice_matches_jax():
    gts, res = _tok(TP)
    for kw in ({}, {"use_synonyms": False}):
        got, want = TS.spice(gts, res, **kw), JS.spice(gts, res, **kw)
        _close(got[0], want[0])
        _close(got[1], want[1])
    for split in ("dev", "heldout"):
        assert TS.parser_deviation(split) == JS.parser_deviation(split)
    toks = "a man riding a red bike next to two parked cars".split()
    assert TS.extract_tuples(toks) == JS.extract_tuples(toks)


def test_meteor_stages_match_jax():
    gts, res = _tok(TP)
    for kw in ({"use_synonyms": False}, {"use_paraphrases": False}):
        _close(TMt.meteor(gts, res, **kw)[0], JMt.meteor(gts, res, **kw)[0])
    words = [w for s in list(gts.values()) + list(res.values())
             for c in s for w in c.split()]
    assert TMt.synonym_coverage(words) == JMt.synonym_coverage(words)
    assert TMt.stemmer_unavailable() is None


def test_compute_all_metrics_matches_jax():
    gts, res = _tok(TP)
    got, want = TM.compute_all_metrics(gts, res), JM.compute_all_metrics(
        gts, res)
    assert list(got) == list(want)
    _close(list(got.values()), list(want.values()))
    assert want["CIDEr"] > 0.5 and want["METEOR"] > 0.1
    assert list(TM.compute_all_metrics(gts, res, stemmed=False)) == [
        "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr"]


def test_ciderd_with_a_document_frequency_pickle(tmp_path):
    """The SCST scorer with the cider repo's df pickle format (a
    defaultdict(float) of n-gram document frequencies)."""
    gts, res = _tok(TP)
    df = defaultdict(float)
    for refs in gts.values():
        for g in set(g for r in refs for g in TM._ngram_counter(r)):
            df[g] += 2
    path = tmp_path / "df.p"
    path.write_bytes(pickle.dumps({"ref_len": 9.0,
                                   "document_frequency": df}))
    got = TM.CiderD(df=str(path)).compute_score(gts, res)
    want = JM.CiderD(df=str(path)).compute_score(gts, res)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_cider_matches_the_native_scorer(monkeypatch):
    monkeypatch.setenv("VITCAP_NATIVE_CIDER", "1")
    gts, res = _tok(TP)
    got, want = TM.cider(gts, res), JM.cider(gts, res)
    _close(got[0], want[0], 1e-9)
    _close(got[1], want[1], 1e-9)


@pytest.fixture
def eval_files(tmp_path):
    gt = str(tmp_path / "test.caption.tsv")
    tsv_writer(((k, json.dumps([{"caption": c} for c in v]))
                for k, v in RAW_GTS.items()), gt)
    pred = str(tmp_path / "pred.predict.tsv")
    tsv_writer(((k, json.dumps([{"caption": v[0], "conf": 0.5}]))
                for k, v in RAW_RES.items()), pred)
    return tmp_path, gt, pred


def _numbers(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_numbers(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)):
            out[prefix + k] = float(v)
        elif isinstance(v, list):
            out.update({f"{prefix}{k}.{i}": float(x)
                        for i, x in enumerate(v)})
    return out


@pytest.mark.parametrize("gt_json", [False, True])
def test_evaluate_on_coco_caption_matches_jax(eval_files, gt_json):
    """The report of both packages from the caption TSV or its COCO json:
    the same keys, every number within 1e-12, the same labels; the file
    the port writes holds its result."""
    tmp, gt, pred = eval_files
    if gt_json:
        from vitcap_tpu_torch.data.tsv import (iter_caption_to_json,
                                               tsv_reader)
        iter_caption_to_json(tsv_reader(gt), str(tmp / "gt.json"))
        gt = str(tmp / "gt.json")
    got = TE.evaluate_on_coco_caption(pred, gt, outfile=str(tmp / "t.rep"))
    want = JE.evaluate_on_coco_caption(pred, gt, outfile=str(tmp / "j.rep"))
    g, w = _numbers(got), _numbers(want)
    assert g.keys() == w.keys()
    for k in w:
        assert abs(g[k] - w[k]) <= 1e-12, (k, g[k], w[k])
    assert got["_impl"]["METEOR"] == want["_impl"]["METEOR"]
    assert json.loads((tmp / "t.rep").read_text()) == got
    for key in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"):
        assert key in got


def test_report_without_nltk_says_why(eval_files, monkeypatch):
    """On a host without nltk METEOR and SPICE are left out and the report
    says why; the other scores are the full report's."""
    tmp, gt, pred = eval_files
    full = TE.evaluate_on_coco_caption(pred, gt, outfile=str(tmp / "f.rep"))
    why = "nltk is not installed (test)"
    monkeypatch.setattr(TMt, "stemmer_unavailable", lambda: why)
    got = TE.evaluate_on_coco_caption(pred, gt)
    assert "METEOR" not in got and "SPICE" not in got
    assert got["_impl"] == {"not_run": {"METEOR": why, "SPICE": why}}
    for k in ("Bleu_1", "Bleu_4", "ROUGE_L", "CIDEr"):
        assert got[k] == full[k]
    assert json.loads((tmp / "pred.predict.report").read_text()) == got


def test_nocaps_json_matches_jax(eval_files):
    tmp, _, pred = eval_files
    TN.prediction_tsv_to_nocaps_json(pred, str(tmp / "t.json"))
    JN.prediction_tsv_to_nocaps_json(pred, str(tmp / "j.json"))
    assert (tmp / "t.json").read_bytes() == (tmp / "j.json").read_bytes()
    ids = {k: i for i, k in enumerate(RAW_RES)}
    TN.prediction_tsv_to_nocaps_json(pred, str(tmp / "t2.json"), ids)
    JN.prediction_tsv_to_nocaps_json(pred, str(tmp / "j2.json"), ids)
    assert (tmp / "t2.json").read_bytes() == (tmp / "j2.json").read_bytes()
