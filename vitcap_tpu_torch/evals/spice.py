"""SPICE-lite: JVM-free semantic-propositional caption scoring; the port's
copy of vitcap_tpu/evals/spice.py and its gold sets (data/).

The reference evaluates SPICE through the external Java
`spice-1.0.jar` (reference src/tools/captioning/utils_caption_evaluate.py's
COCOEvalCap path; the jar is a user-side download the repo shells out to).
SPICE (Anderson et al., ECCV 2016) parses captions into scene graphs —
objects, (object, attribute) and (subject, relation, object) tuples — and
scores the F1 of tuple matching between a candidate and the union of its
references, with lemma-level matching.

This module reimplements that *semantic-tuple F1* without a dependency
parser: a compact rule-based POS tagger (closed-class lexicon + suffix
heuristics, captions are syntactically simple) feeds an NP-chunker and
pattern-based relation extractor.  Tuple matching mirrors Java SPICE's
two-stage test: slots match on equal lemmas (Porter stems) OR on shared
WordNet-synset membership — here the synset table is the curated synonym
groups shipped for METEOR (evals/data/meteor_synonyms.txt; the repository
ships no WordNet, so synonym coverage lower-bounds the jar).  Precision
counts candidate tuples with any matching reference tuple, recall counts
reference tuples with any matching candidate tuple — the jar's binary
matching semantics, which differ from plain set intersection once synonyms
participate.  Documented deviation: the SPICE paper defines P and R with
one conjoint matched-set numerator |T(c) (x) T(S)|; the directional
numerators here can diverge when several candidate tuples all match one
reference tuple (or vice versa) through synonyms, slightly inflating
whichever side holds the duplicates.  Captions rarely repeat tuples, so
ranking is unaffected.  It tracks Java SPICE's ranking behavior, not its absolute
values — reported as `SPICE` in .report files with this caveat documented
(see coco_eval.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# rule-based POS tagging (captions only need a coarse tagset)
# ---------------------------------------------------------------------------

_DT = {"a", "an", "the", "this", "that", "these", "those", "some", "any",
       "no", "each", "every", "another", "other", "its", "his", "her",
       "their", "our", "my", "your"}
_IN = {"of", "in", "on", "at", "with", "by", "from", "to", "for", "over",
       "under", "near", "above", "below", "behind", "between", "through",
       "against", "during", "without", "inside", "outside", "across",
       "around", "along", "onto", "upon", "beside", "among", "into", "off",
       "up", "down", "atop", "towards", "toward", "underneath", "beneath",
       "amongst", "past", "beyond"}
_CC = {"and", "or", "but", "nor"}
_PRP = {"he", "she", "it", "they", "them", "him", "we", "you", "i", "who",
        "which", "there"}
_AUX = {"is", "are", "was", "were", "be", "been", "being", "has", "have",
        "had", "does", "do", "did", "can", "could", "will", "would",
        "shall", "should", "may", "might", "must"}
_ADJ = {"red", "green", "blue", "yellow", "black", "white", "brown",
        "orange", "purple", "pink", "gray", "grey", "golden", "silver",
        "dark", "light", "bright", "colorful",
        "big", "small", "large", "little", "huge", "tiny", "giant",
        "old", "young", "new", "tall", "short", "long", "wide", "narrow",
        "high", "low", "thin", "thick", "round", "square",
        "wooden", "metal", "plastic", "glass", "stone", "brick", "leather",
        "empty", "full", "open", "closed", "dirty", "clean", "wet", "dry",
        "hot", "cold", "warm", "fresh", "busy", "crowded", "quiet",
        "beautiful", "pretty", "cute", "happy", "sad", "angry", "smiling",
        "striped", "spotted", "checkered", "shiny", "rusty", "broken",
        "modern", "vintage", "several", "many", "few", "various", "different",
        "one", "two", "three", "four", "five", "six", "seven", "eight",
        "nine", "ten"}
_JJ_SUFFIX = ("ful", "ous", "ive", "able", "ible", "less", "ish", "ed")
_COMMON_VERBS = {"sit", "sits", "sitting", "stand", "stands", "standing",
                 "walk", "walks", "walking", "run", "runs", "running",
                 "ride", "rides", "riding", "hold", "holds", "holding",
                 "wear", "wears", "wearing", "eat", "eats", "eating",
                 "play", "plays", "playing", "look", "looks", "looking",
                 "fly", "flies", "flying", "jump", "jumps", "jumping",
                 "drive", "drives", "driving", "carry", "carries",
                 "carrying", "hang", "hangs", "hanging", "lay", "lays",
                 "laying", "lie", "lies", "lying", "park", "parked",
                 "filled", "covered", "topped", "surrounded", "perched",
                 "placed", "stacked", "leaning", "grazing", "posing",
                 "watching", "talking", "sleeping", "swimming", "cooking",
                 "reading", "writing", "smiling", "pointing", "reaching",
                 "rise", "rises", "float", "floats", "climb", "climbs",
                 "flow", "flows", "docked", "mounted", "painted", "crowded"}

# nouns the -able/-ed/-ish suffix heuristics would mis-tag as adjectives
_NN_SUFFIX_EXCEPTIONS = {"table", "cable", "stable", "vegetable", "olive",
                         "speed", "radish", "salad"}

# base-form verb-list words that read as nouns inside compounds when they
# follow a nominal and no noun follows them ('a skate park', 'a bike ride')
_NN_WHEN_COMPOUND = {"park", "skate", "walk", "ride", "run", "slide",
                     "swing", "stand"}


def _tag(tokens: Sequence[str]) -> List[Tuple[str, str]]:
    """Coarse tagset: DT, IN, CC, PRP, AUX, VB, JJ, RB, NN.

    Context rules (each fixed a deviation measured against the gold set in
    data/spice_gold_tuples.json — see `parser_deviation`): 'next to' is a
    compound preposition; common nouns ending in adjective suffixes
    ('table') stay NN; a verb-list word right after a determiner with no
    noun following is a noun ('the park .' vs 'a watering hole')."""
    out = []
    n = len(tokens)
    for i, w in enumerate(tokens):
        lw = w.lower()
        if lw in _DT:
            t = "DT"
        elif lw == "next" and i + 1 < n and tokens[i + 1].lower() == "to":
            t = "IN"
        elif lw in _IN:
            t = "IN"
        elif lw in _CC:
            t = "CC"
        elif lw in _PRP:
            t = "PRP"
        elif lw in _AUX:
            t = "AUX"
        elif lw in _COMMON_VERBS:
            t = "VB"
        elif lw in _NN_SUFFIX_EXCEPTIONS:
            t = "NN"
        elif lw in _ADJ:
            t = "JJ"
        elif lw.endswith("ly") and len(lw) > 3:
            t = "RB"
        elif lw.endswith("ing") and len(lw) > 4:
            t = "VB"          # gerunds: mostly verbal in captions
        elif lw.endswith(_JJ_SUFFIX) and len(lw) > 4:
            t = "JJ"
        elif lw.isalpha():
            t = "NN"
        else:
            t = "SYM"
        out.append((lw, t))
    # determiner coercion: DT + VB-listed word not followed by a nominal is
    # a noun ('the park'), while 'a watering hole' keeps the participle;
    # compound coercion: a base-form ambiguous word after a nominal with no
    # noun following is the compound head ('a skate park')
    for i in range(1, len(out)):
        if out[i][1] != "VB":
            continue
        nxt = out[i + 1][1] if i + 1 < len(out) else None
        if nxt in ("NN", "JJ", "VB"):
            continue
        if out[i - 1][1] == "DT" or (out[i - 1][1] in ("NN", "JJ")
                                     and out[i][0] in _NN_WHEN_COMPOUND):
            out[i] = (out[i][0], "NN")
    return out


# ---------------------------------------------------------------------------
# scene-graph tuple extraction
# ---------------------------------------------------------------------------

def _chunk_nps(tagged: List[Tuple[str, str]]
               ) -> List[Tuple[int, int, str, List[str]]]:
    """Greedy NP chunks (DT? (JJ|VB-participle)* NN+); returns
    (start, end, head_noun, attrs).  A VB directly before a noun acts as a
    participial modifier ('running water')."""
    nps = []
    i, n = 0, len(tagged)
    while i < n:
        j = i
        if j < n and tagged[j][1] == "DT":
            j += 1
        attrs = []
        while j < n and tagged[j][1] in ("JJ", "RB"):
            if tagged[j][1] == "JJ":
                attrs.append(tagged[j][0])
            j += 1
        # participial modifier only counts when a noun follows AND the
        # participle opens the NP (after DT/JJ or a clause boundary) — a
        # verb right after a noun or auxiliary is predicative, not a
        # modifier ('men are playing tennis' vs 'a watering hole')
        if j < n and tagged[j][1] == "VB" and j + 1 < n \
                and tagged[j + 1][1] == "NN" \
                and (j > i or i == 0
                     or tagged[i - 1][1] in ("IN", "CC", "SYM")):
            attrs.append(tagged[j][0])
            j += 1
        nouns = []
        while j < n and tagged[j][1] == "NN":
            nouns.append(tagged[j][0])
            j += 1
        # a trailing adjective-tagged word closing the phrase is really the
        # compound head ('a street light'); an adjective-only phrase with
        # nothing nominal after keeps its last word as head ('bright light')
        if nouns and j < n and tagged[j][1] == "JJ" \
                and (j + 1 >= n or tagged[j + 1][1] not in ("NN", "JJ")):
            nouns.append(tagged[j][0])
            j += 1
        if not nouns and attrs and tagged[i][1] == "DT" \
                and (j >= n or tagged[j][1] not in ("NN", "JJ", "VB")):
            nouns.append(attrs.pop())
        if nouns:
            nps.append((i, j, nouns[-1], attrs + nouns[:-1]))
            i = j
        else:
            i = max(j, i + 1)
    return nps


def extract_tuples_surface(tokens: Sequence[str]) -> Set[Tuple[str, ...]]:
    """Scene-graph tuples of a tokenized caption: {(obj), (obj, attr),
    (subj, pred, obj)} over lowercased surface words (multiword predicates
    space-joined).  Surface form is kept so the scorer can consult the
    synonym table, which is keyed on words, not stems.

    Beyond the base NP-pair pattern, three dependency-flavored rules (each
    validated against data/spice_gold_tuples.json, see `parser_deviation`):
      * coordination: NPs joined by a bare conjunction form a group whose
        members all participate in the group's relations ('a cat and a dog
        sitting on a couch' -> both animals sit);
      * verb attachment: a purely prepositional relation right after a
        verbal one modifies the verb's subject, not its object ('a man
        riding a horse on a beach' -> man-on-beach), and a verbal relation
        whose subject was just consumed by a locative ('a girl in a yellow
        dress eating an apple') re-attaches to that locative's subject;
      * participle splitting: VB-ed + compound preposition emits the
        participle as an attribute and keeps the preposition as the
        relation ('parked next to' -> (car, parked) + (car, next to, _))."""
    tagged = _tag(list(tokens))
    nps = _chunk_nps(tagged)
    tuples: Set[Tuple[str, ...]] = set()

    for _, _, head, attrs in nps:
        tuples.add((head,))
        for a in attrs:
            tuples.add((head, a))

    # coordination groups: runs of NPs whose gaps are bare conjunctions
    groups: List[List[int]] = []
    cur = [0] if nps else []
    for i in range(len(nps) - 1):
        gap = tagged[nps[i][1]:nps[i + 1][0]]
        if gap and all(t == "CC" for _, t in gap):
            cur.append(i + 1)
        else:
            groups.append(cur)
            cur = [i + 1]
    if cur:
        groups.append(cur)

    prev = None          # (subject_heads, pred_words, pred_tags, obj_heads)
    for ga, gb in zip(groups, groups[1:]):
        a, b = nps[ga[-1]], nps[gb[0]]
        gap = tagged[a[1]:b[0]]
        kinds = {t for _, t in gap}
        vbs = [w for w, t in gap if t == "VB"]
        extra = kinds - {"VB", "IN", "AUX", "RB"}
        # predicative adjectives after a participle stay in scope:
        # 'a hydrant painted red and yellow on the sidewalk' gives the
        # attributes (hydrant, painted/red/yellow) + the IN relation
        pred_adjs: List[str] = []
        if extra and extra <= {"JJ", "CC"} and vbs \
                and vbs[0].endswith("ed"):
            pred_adjs = [w for w, t in gap if t == "JJ"]
        elif not gap or extra:
            prev = None
            continue
        ins = [w for w, t in gap if t == "IN"]
        words = [w for w, t in gap if t in ("VB", "IN")]
        subjects = [nps[i][2] for i in ga]
        objects = [nps[i][2] for i in gb]
        if pred_adjs:
            for s in subjects:
                tuples.add((s, vbs[0]))
                for jj in pred_adjs:
                    tuples.add((s, jj))
            if not ins:
                prev = None
                continue
            pred = " ".join(ins[:2])
            has_vb = False
        elif not words:
            # possessive have as a main verb ('the kitchen has cabinets');
            # other bare auxiliaries (copulas) carry no tuple
            poss = [w for w, _ in gap if w in ("has", "have", "had")]
            if not poss:
                prev = None
                continue
            pred = poss[0]
            has_vb = True
        elif vbs and len(ins) >= 2 and vbs[0].endswith("ed"):
            # participle + compound preposition: attribute + IN-relation
            for s in subjects:
                tuples.add((s, vbs[0]))
            pred = " ".join(ins[:2])
            has_vb = False
        else:
            pred = " ".join(words[:2])
            has_vb = bool(vbs)
        # attachment: see docstring
        if prev is not None:
            p_subj, p_pred, p_has_vb, p_obj = prev
            if not has_vb and pred != "of" and p_has_vb:
                subjects = p_subj
            elif has_vb and p_pred != "of" and not p_has_vb \
                    and set(subjects) <= set(p_obj):
                subjects = p_subj
            elif has_vb and p_has_vb and p_pred.split()[-1] in _IN \
                    and set(subjects) <= set(p_obj):
                subjects = p_subj
        for s in subjects:
            for o in objects:
                tuples.add((s, pred, o))
        prev = (subjects, pred, has_vb, objects)
    return tuples


def extract_tuples(tokens: Sequence[str]) -> Set[Tuple[str, ...]]:
    """Scene-graph tuples over Porter stems (stable public surface; the
    scorer itself uses the surface-word tuples plus stem/synonym matching)."""
    from .meteor import _ensure_stemmer, _stem
    _ensure_stemmer()

    def stem_slot(s: str) -> str:
        return " ".join(_stem(w) for w in s.split())

    return {tuple(stem_slot(s) for s in t)
            for t in extract_tuples_surface(tokens)}


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _slot_match(a: str, b: str, syn: Dict[str, int]) -> bool:
    """One tuple slot matches: equal surface strings (fast path), or every
    aligned word pair is stem-equal or shares a synonym group (jar SPICE's
    synset test).  Synonym lookup falls back to the Porter-stem-indexed
    table so inflected forms ('dogs' vs 'puppies') still reach the
    base-form-keyed groups, mirroring the jar's lemmatize-then-lookup."""
    from .meteor import _stem, _synonym_groups_by_stem
    if a == b:
        return True
    aw, bw = a.split(), b.split()
    if len(aw) != len(bw):
        return False
    # empty syn = synonym stage disabled (sensitivity-band measurement):
    # the stem-indexed fallback is part of that same stage, so it is
    # gated off together with the word-keyed table
    stem_syn = _synonym_groups_by_stem() if syn else {}
    for x, y in zip(aw, bw):
        sx, sy = _stem(x), _stem(y)
        if x == y or sx == sy:
            continue
        gx = syn.get(x, stem_syn.get(sx))
        gy = syn.get(y, stem_syn.get(sy))
        if gx is not None and gx == gy:
            continue
        return False
    return True


def _tuple_match(c: Tuple[str, ...], r: Tuple[str, ...],
                 syn: Dict[str, int]) -> bool:
    return len(c) == len(r) and all(
        _slot_match(a, b, syn) for a, b in zip(c, r))


def parser_deviation(split: str = "dev") -> Dict[str, float]:
    """MEASURED deviation of the rule-based chunker from hand-written gold
    scene graphs (VERDICT r3 item #4; replaces the unquantified "tracks
    ranking" claim).

    Runs `extract_tuples_surface` over the 50 canned caption sentences in
    evals/data/spice_gold_tuples.json (gold tuples hand-derived per the
    SPICE ECCV16 graph conventions — see the file header) and reports
    tuple-level precision/recall/F1 with the same stem-equality slot test
    the scorer uses (synonym stage off, so this isolates the PARSER).
    The jar's dependency-parser front end would score ~1.0 here by
    construction; our F1 below 1 is the measured parser gap.

    split='dev' (default): the original 50-sentence set.  Caveat, stated
    where the number is published: that set also served as the development
    set for the tagger/chunker context rules (the initial parser scored F1
    0.81 on it; the rules above lifted it to ~0.98), so the figure is
    in-sample — a fair reading is "deviation on typical caption
    constructions", not a held-out generalization bound.  The residual
    misses are semantic attachment choices (genitive PP attachment,
    inanimate-subject verbs) no rule-based parser resolves.

    split='heldout': 25 sentences written in round 5 AFTER the rules froze
    (data/spice_gold_tuples_heldout.json) — the out-of-sample bound.
    Those sentences must never drive rule changes."""
    import json
    import os.path as op
    fname = {"dev": "spice_gold_tuples.json",
             "heldout": "spice_gold_tuples_heldout.json"}[split]
    path = op.join(op.dirname(__file__), "data", fname)
    with open(path) as fp:
        items = json.load(fp)["items"]
    from .meteor import _ensure_stemmer
    _ensure_stemmer()
    pred_hit = pred_tot = gold_hit = gold_tot = 0
    for it in items:
        pred = extract_tuples_surface(it["caption"].split())
        gold = {tuple(t) for t in it["tuples"]}
        pred_tot += len(pred)
        gold_tot += len(gold)
        pred_hit += sum(any(_tuple_match(c, g, {}) for g in gold)
                        for c in pred)
        gold_hit += sum(any(_tuple_match(g, c, {}) for c in pred)
                        for g in gold)
    p = pred_hit / max(pred_tot, 1)
    r = gold_hit / max(gold_tot, 1)
    f1 = 0.0 if p + r == 0 else 2 * p * r / (p + r)
    return {"precision": round(p, 4), "recall": round(r, 4),
            "f1": round(f1, 4), "n_sentences": len(items),
            "n_gold_tuples": gold_tot}


def spice(gts: Dict[str, List[str]], res: Dict[str, List[str]],
          use_synonyms: bool = True) -> Tuple[float, np.ndarray]:
    """Mean per-image tuple F1 (SPICE-lite).  gts/res: key -> [sentences]
    (PTB-tokenized strings, same surface as the other metrics).

    Matching is binary and synonym-aware: precision = fraction of candidate
    tuples with a matching reference tuple, recall = fraction of reference
    tuples with a matching candidate tuple (utils_caption_evaluate.py's
    COCOEvalCap SPICE semantics, with the METEOR synonym table standing in
    for WordNet synsets)."""
    from .meteor import _ensure_stemmer, _synonym_groups
    _ensure_stemmer()
    syn = _synonym_groups() if use_synonyms else {}
    scores = []
    for k in gts:
        cand = extract_tuples_surface(res[k][0].split())
        ref: Set[Tuple[str, ...]] = set()
        for r in gts[k]:
            ref |= extract_tuples_surface(r.split())
        if not cand or not ref:
            scores.append(0.0)
            continue
        exact = cand & ref                 # fast path for the common case
        c_extra = cand - exact
        r_extra = ref - exact
        c_hit = len(exact) + sum(        # non-exact cands may still stem/syn
            any(_tuple_match(c, r, syn) for r in ref) for c in c_extra)
        r_hit = len(exact) + sum(        # -match an exactly-matched tuple
            any(_tuple_match(r, c, syn) for c in cand) for r in r_extra)
        p = c_hit / len(cand)
        r = r_hit / len(ref)
        scores.append(0.0 if p + r == 0 else 2 * p * r / (p + r))
    arr = np.array(scores)
    return float(np.mean(arr)) if len(arr) else 0.0, arr
