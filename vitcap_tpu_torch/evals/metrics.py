"""CIDEr-D, the port's copy of the scorer in vitcap_tpu/evals/metrics.py
(CiderD and its n-gram helpers), pure Python and numpy.

The SCST reward (solver/scst.py) scores B * (K + 1) captions with it every
step.  1..4-gram tf-idf vectors (idf = log N - log df), a per-n cosine
with count clipping and a gaussian length penalty (sigma 6), times 10
(pyciderevalcap's ciderD_scorer).  Document frequencies come from the
references of each call (df='corpus') or from a pickle
{'ref_len', 'document_frequency'} (the cider repo's coco-train-words.p
format).  The other caption metrics and the JAX package's native C++
scorer (native/cider.cpp) are not part of this copy.

Scorers take {id: [hypothesis]} and {id: [references]} of tokenized,
space-joined strings.
"""

from __future__ import annotations

import pickle
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


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
