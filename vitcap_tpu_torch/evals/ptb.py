"""PTB-style caption tokenizer, JVM-free; the port's copy of
vitcap_tpu/evals/ptb.py.

Replacement for the Stanford-CoreNLP PTBTokenizer subprocess that
pycocoevalcap shells out to (reference eval path: SURVEY.md §3.3;
utils_caption_evaluate.py:95-107).  Reproduces the behaviors that matter
for caption scoring: lowercasing, punctuation-token removal (the same
PUNCTUATIONS list pycocoevalcap uses), PTB contraction splitting
(don't -> do n't, it's -> it 's), and symbol isolation.
"""

from __future__ import annotations

import re
from typing import Dict, List

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS
PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"}

_CONTRACTIONS = re.compile(
    r"\b(can)(not)\b|"
    r"\b(d)('ye)\b|"
    r"\b(gim)(me)\b|"
    r"\b(gon)(na)\b|"
    r"\b(got)(ta)\b|"
    r"\b(lem)(me)\b|"
    r"\b(wan)(na)\b", re.IGNORECASE)

_APOS = re.compile(r"([a-z])('s|'m|'d|'ll|'re|'ve|n't)\b", re.IGNORECASE)
_TOKEN = re.compile(r"[a-z0-9]+(?:[.'\-][a-z0-9]+)*|'[a-z]+|[^\sa-z0-9]",
                    re.IGNORECASE)


def ptb_tokenize_sentence(text: str) -> List[str]:
    text = text.replace("\n", " ")
    text = _CONTRACTIONS.sub(lambda m: " ".join(g for g in m.groups() if g),
                             text)
    text = _APOS.sub(r"\1 \2", text)
    toks = _TOKEN.findall(text.lower())
    return [t for t in toks if t not in PUNCTUATIONS]


def ptb_tokenize(captions_for_image: Dict[str, List[dict]]
                 ) -> Dict[str, List[str]]:
    """pycocoevalcap-compatible interface: {img_id: [{'caption': str}, ...]}
    -> {img_id: ['tok tok ...', ...]}."""
    return {
        k: [" ".join(ptb_tokenize_sentence(c["caption"])) for c in caps]
        for k, caps in captions_for_image.items()
    }
