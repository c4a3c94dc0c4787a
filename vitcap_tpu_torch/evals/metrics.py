"""Caption metrics: BLEU, CIDEr/CIDEr-D, ROUGE-L, METEOR, SPICE-lite, the
port's copy of vitcap_tpu/evals/metrics.py: pure Python and numpy, no JVM
(the reference shells out to Stanford/Java jars).

Algorithms follow the published pycocoevalcap / cider implementations:
- BLEU: corpus-level with per-sentence clipped n-gram counts, 'closest'
  effective reference length, tiny/small smoothing, brevity penalty
  (pycocoevalcap bleu/bleu_scorer.py).
- CIDEr-D: 1..4-gram tf-idf vectors (idf = log N - log df), per-n cosine
  with count clipping and gaussian length penalty sigma=6, x10
  (pyciderevalcap's ciderD_scorer); document frequencies from the
  references of each call (df='corpus') or from a pickle
  {'ref_len', 'document_frequency'} (the cider repo's coco-train-words.p
  format).  The SCST reward (solver/scst.py) scores B * (K + 1) captions
  with it every step: with df='corpus' and n = 4 the scorer runs in C++
  (evals/native_cider.py) unless VITCAP_NATIVE_CIDER=0 selects the
  Python scorer, its plain version.
- ROUGE-L: LCS F-beta with beta=1.2, max over refs (pycocoevalcap rouge).
- METEOR and SPICE-lite: evals/meteor.py and evals/spice.py (their
  stemmer is nltk's Porter stemmer).

All scorers take {id: [hyp_sentence]} and {id: [ref_sentences]} of
pre-tokenized (space-joined) strings, like pycocoevalcap after PTBTokenizer.
"""

from __future__ import annotations

import math
import os
import pickle
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

def _ngrams(words: List[str], n: int) -> Counter:
    return Counter(tuple(words[i:i + n]) for i in range(len(words) - n + 1))


def _all_ngrams(sentence: str, max_n: int = 4) -> List[Counter]:
    words = sentence.split()
    return [_ngrams(words, n + 1) for n in range(max_n)]


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def bleu(gts: Dict[str, List[str]], res: Dict[str, List[str]], n: int = 4,
         option: str = "closest") -> Tuple[List[float], List[List[float]]]:
    """Returns ([bleu1..bleuN] corpus, per-image lists)."""
    tiny, small = 1e-15, 1e-9
    tot_correct = np.zeros(n)
    tot_guess = np.zeros(n)
    tot_testlen = 0.0
    tot_reflen = 0.0
    per_image: List[List[float]] = []

    for k in gts:
        hyp = res[k][0].split()
        refs = [r.split() for r in gts[k]]
        testlen = len(hyp)
        rls = [len(r) for r in refs]
        if option == "shortest":
            reflen = min(rls)
        elif option == "average":
            reflen = sum(rls) / len(rls)
        else:  # closest
            reflen = min(rls, key=lambda rl: (abs(rl - testlen), rl))
        correct = np.zeros(n)
        guess = np.zeros(n)
        for i in range(n):
            hng = _ngrams(hyp, i + 1)
            best = Counter()
            for r in refs:
                rng_ = _ngrams(r, i + 1)
                for g, c in rng_.items():
                    best[g] = max(best[g], c)
            correct[i] = sum(min(c, best[g]) for g, c in hng.items())
            guess[i] = max(testlen - i, 0)
        tot_correct += correct
        tot_guess += guess
        tot_testlen += testlen
        tot_reflen += reflen

        b, row = 1.0, []
        for i in range(n):
            b *= (correct[i] + tiny) / (guess[i] + small)
            s = b ** (1.0 / (i + 1))
            ratio = (testlen + tiny) / (reflen + small)
            row.append(s * math.exp(1 - 1 / ratio) if ratio < 1 else s)
        per_image.append(row)

    scores, b = [], 1.0
    for i in range(n):
        b *= (tot_correct[i] + tiny) / (tot_guess[i] + small)
        s = b ** (1.0 / (i + 1))
        ratio = (tot_testlen + tiny) / (tot_reflen + small)
        scores.append(float(s * math.exp(1 - 1 / ratio) if ratio < 1 else s))
    return scores, per_image


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def _ngram_counter(sentence: str, n: int = 4) -> Counter:
    """Counts of every 1..n-gram of the sentence's words."""
    words = sentence.split()
    c: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            c[tuple(words[i:i + k])] += 1
    return c


class CiderD:
    def __init__(self, n: int = 4, sigma: float = 6.0,
                 df: str = "corpus", df_path: Optional[str] = None):
        """df='corpus': document frequencies from the references of each
        call; otherwise df_path (or df itself) names the pickle."""
        self.n = n
        self.sigma = sigma
        self.df_mode = df
        self.doc_freq = None
        self.ref_len = None
        if df != "corpus":
            with open(df_path or df, "rb") as f:
                d = pickle.load(f, encoding="latin1")
            self.doc_freq = d["document_frequency"]
            self.ref_len = np.log(float(d["ref_len"]))

    def _counts2vec(self, cnts: Counter, doc_freq, ref_len):
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, tf in cnts.items():
            df = np.log(max(1.0, doc_freq[ngram]))
            n = len(ngram) - 1
            vec[n][ngram] = float(tf) * (ref_len - df)
            norm[n] += vec[n][ngram] ** 2
            if n == 1:
                length += tf
        return vec, [np.sqrt(x) for x in norm], length

    def _sim(self, vh, vr, nh, nr, lh, lr):
        delta = float(lh - lr)
        val = np.zeros(self.n)
        for i in range(self.n):
            for ngram, c in vh[i].items():
                val[i] += min(c, vr[i][ngram]) * vr[i][ngram]
            if nh[i] != 0 and nr[i] != 0:
                val[i] /= (nh[i] * nr[i])
            val[i] *= np.e ** (-(delta ** 2) / (2 * self.sigma ** 2))
        return val

    def compute_score(self, gts: Dict[str, List[str]],
                      res: Dict[str, List[str]]
                      ) -> Tuple[float, np.ndarray]:
        """(corpus mean, per-id scores in the order of gts' keys)."""
        if self.df_mode == "corpus" and self.n == 4 \
                and os.environ.get("VITCAP_NATIVE_CIDER", "1") != "0":
            from .native_cider import ciderd_corpus_native
            return ciderd_corpus_native(gts, res, self.sigma)
        keys = list(gts.keys())
        crefs = [[_ngram_counter(r, self.n) for r in gts[k]] for k in keys]
        ctest = [_ngram_counter(res[k][0], self.n) for k in keys]
        if self.df_mode == "corpus":
            doc_freq = defaultdict(float)
            for refs in crefs:
                for ngram in set(g for ref in refs for g in ref):
                    doc_freq[ngram] += 1
            ref_len = np.log(float(len(crefs)))
        else:
            doc_freq, ref_len = self.doc_freq, self.ref_len
        scores = []
        for test, refs in zip(ctest, crefs):
            vh, nh, lh = self._counts2vec(test, doc_freq, ref_len)
            score = np.zeros(self.n)
            for ref in refs:
                vr, nr, lr = self._counts2vec(ref, doc_freq, ref_len)
                score += self._sim(vh, vr, nh, nr, lh, lr)
            scores.append(np.mean(score) / len(refs) * 10.0)
        scores = np.array(scores)
        return float(np.mean(scores)), scores


def cider(gts, res, n=4, sigma=6.0) -> Tuple[float, np.ndarray]:
    """Plain CIDEr = CIDEr-D scorer here (pycocoevalcap's Cider differs only
    in length-penalty/clipping details; COCOEvalCap reports CIDEr from the
    cider scorer — this implementation follows the -D variant used both for
    the README metric and for SCST)."""
    return CiderD(n=n, sigma=sigma).compute_score(gts, res)


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l(gts: Dict[str, List[str]], res: Dict[str, List[str]],
            beta: float = 1.2) -> Tuple[float, np.ndarray]:
    scores = []
    for k in gts:
        hyp = res[k][0].split()
        prec, rec = [], []
        for r in gts[k]:
            ref = r.split()
            l = _lcs_len(hyp, ref)
            prec.append(l / len(hyp) if hyp else 0.0)
            rec.append(l / len(ref) if ref else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            scores.append(((1 + beta ** 2) * p * r) / (r + beta ** 2 * p))
        else:
            scores.append(0.0)
    arr = np.array(scores)
    return float(np.mean(arr)), arr


# ---------------------------------------------------------------------------
# METEOR (native meteor-1.5: exact/stem/synonym/paraphrase-hook matchers,
# module weights, content/function word discounting — evals/meteor.py)
# ---------------------------------------------------------------------------

def meteor(gts: Dict[str, List[str]], res: Dict[str, List[str]],
           synonym_file: Optional[str] = None,
           paraphrase_file: Optional[str] = None,
           use_synonyms: bool = True,
           use_paraphrases: bool = True) -> Tuple[float, np.ndarray]:
    from .meteor import meteor as _meteor
    return _meteor(gts, res, synonym_file=synonym_file,
                   paraphrase_file=paraphrase_file,
                   use_synonyms=use_synonyms,
                   use_paraphrases=use_paraphrases)


# ---------------------------------------------------------------------------
# aggregate scorer (COCOEvalCap-style)
# ---------------------------------------------------------------------------

def compute_all_metrics(gts: Dict[str, List[str]],
                        res: Dict[str, List[str]],
                        stemmed: bool = True) -> Dict[str, float]:
    """Bleu_1..4, METEOR, ROUGE_L, CIDEr, SPICE.  stemmed=False leaves out
    METEOR and SPICE, which need the Porter stemmer (evals/coco_eval.py
    says so in the report)."""
    out: Dict[str, float] = {}
    b, _ = bleu(gts, res, 4)
    for i, s in enumerate(b):
        out[f"Bleu_{i + 1}"] = s
    if stemmed:
        out["METEOR"], _ = meteor(gts, res)
    out["ROUGE_L"], _ = rouge_l(gts, res)
    out["CIDEr"], _ = cider(gts, res)
    if stemmed:
        from .spice import spice
        out["SPICE"], _ = spice(gts, res)   # SPICE-lite (evals/spice.py):
    return out                              # tuple-F1 without the parser
