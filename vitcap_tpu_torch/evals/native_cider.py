"""The native CIDEr-D scorer (vitcap_tpu_torch/native/cider.cpp), the
port's copy of vitcap_tpu/evals/native_cider.py.

The SCST reward scores B * (K + 1) captions against their references
every step (solver/scst.py); this is metrics.CiderD(df='corpus') in C++:
words are interned to int32 ids here, n-grams hashed to 64-bit keys
there.  metrics.CiderD.compute_score routes to it; the pure-Python scorer
stays as its plain version (VITCAP_NATIVE_CIDER=0).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np

from ..native import library


def _intern(sentences: List[List[str]], vocab: Dict[str, int]
            ) -> Tuple[np.ndarray, np.ndarray]:
    words, offs = [], [0]
    for s in sentences:
        for w in s:
            words.append(vocab.setdefault(w, len(vocab)))
        offs.append(len(words))
    return (np.asarray(words, np.int32),
            np.asarray(offs, np.int64))


def ciderd_corpus_native(gts: Dict[str, List[str]],
                         res: Dict[str, List[str]],
                         sigma: float = 6.0) -> Tuple[float, np.ndarray]:
    """Same interface and result as metrics.CiderD(df='corpus')
    .compute_score: (corpus mean, per-id scores in the order of gts'
    keys).  Raises if the library cannot be built."""
    lib = library("cider")
    keys = list(gts.keys())
    vocab: Dict[str, int] = {}
    hyps = [res[k][0].split() for k in keys]
    refs: List[List[str]] = []
    img_off = [0]
    for k in keys:
        for r in gts[k]:
            refs.append(r.split())
        img_off.append(len(refs))
    hw, ho = _intern(hyps, vocab)
    rw, ro = _intern(refs, vocab)
    io = np.asarray(img_off, np.int64)
    out = np.zeros(len(keys), np.float64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.ciderd_corpus(p(hw, ctypes.c_int32), p(ho, ctypes.c_int64),
                      p(rw, ctypes.c_int32), p(ro, ctypes.c_int64),
                      p(io, ctypes.c_int64), len(keys), sigma,
                      p(out, ctypes.c_double))
    return float(out.mean()), out
