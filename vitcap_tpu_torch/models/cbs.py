"""Constrained beam search over a finite-state machine of constraint words,
the port of vitcap_tpu/models/cbs.py (reference utils_cbs.py:
ConstrainedBeamSearch, select_best_beam_with_constraints, ConstraintFilter,
FiniteStateMachineBuilder; `use_cbs` in generate).

- Host: the constraint filter (blacklist, hierarchy NMS, top-k,
  replacements), the dense (S, S, V) uint8 FSM builder and its sparse
  mirror (a default target state per row, removed words, exception
  edges), the best-beam selection.  numpy, as in the JAX package.
- Device: the dense and the sparse searches over the port's decode engines
  (models/decode._decode_engine: the eager step, or the fused step with
  VITCAP_DECODE_FUSED=1).  One context is built for the B images and
  shared by their G = S x beam_size beams; the beams' caption caches are
  gathered on every reorder.  The sparse search is the production path:
  its only V-wide work per step is one top-K per beam.

Tie order: every top-k here is lax.top_k's (values descending, ties to the
lower index; `top_k`, exact through int64 keys), and where the JAX package
calls its exact_top_k the port calls `exact_top_k_jax`, which also returns
index 0 where a row's top-k reaches -inf, as that function does.  So dead
beams carry the same filler tokens in both packages.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import decode as D
from .config import ModelConfig

NEG_INF = float("-inf")
STEP_MASK = -1e20       # the reference's masked_fill(-1e20) inside steps
DEAD = -1e12            # the sparse search's finite sentinel
TOPK_CHUNK = 1 << 26    # elements of the dense search's masked block


# ---------------------------------------------------------------------------
# constraint filtering (host)
# ---------------------------------------------------------------------------

BLACKLIST = [
    "auto part", "bathroom accessory", "bicycle wheel", "boy", "building",
    "clothing", "door handle", "fashion accessory", "footwear", "girl",
    "hiking equipment", "human arm", "human beard", "human body",
    "human ear", "human eye", "human face", "human foot", "human hair",
    "human hand", "human head", "human leg", "human mouth", "human nose",
    "land vehicle", "mammal", "man", "person", "personal care", "plant",
    "plumbing fixture", "seat belt", "skull", "sports equipment", "tire",
    "tree", "vehicle registration plate", "wheel", "woman", "__background__",
]

REPLACEMENTS = {
    "band-aid": "bandaid",
    "wood-burning stove": "wood burning stove",
    "kitchen & dining room table": "table",
    "salt and pepper shakers": "salt and pepper",
    "power plugs and sockets": "power plugs",
    "luggage and bags": "luggage",
}


def _node_heights(hierarchy: dict) -> List[Tuple[str, int]]:
    """[(LabelName lower, height)] in preorder (the reference's anytree
    findall order; the first substring match wins)."""
    out: List[Tuple[str, int]] = []

    def height(node) -> int:
        return 1 + max((height(c) for c in node.get("Subcategory", [])),
                       default=-1)

    def walk(node):
        name = node.get("LabelName", "").lower()
        if name:
            out.append((name, height(node)))
        for c in node.get("Subcategory", []):
            walk(c)

    walk(hierarchy)
    return out


class ConstraintFilter:
    """blacklist -> hierarchy NMS (IoU >= thr: the finer class suppresses
    the coarser) -> top-k by confidence -> replacements -> dedup.  The
    dedup is list(set(names)), as in the reference: its order follows the
    process's string hash seed."""

    def __init__(self, hierarchy_jsonpath: str, nms_threshold: float = 0.85,
                 max_given_constraints: int = 3):
        with open(hierarchy_jsonpath) as fp:
            self._heights = _node_heights(json.load(fp))
        self._nms_threshold = nms_threshold
        self._max_given_constraints = max_given_constraints

    def _height(self, class_name: str) -> int:
        # reference: findall(node.LabelName.lower() in c)[0].height, the
        # first preorder node whose name is a substring of the class name
        for name, h in self._heights:
            if name and name in class_name:
                return h
        return 0

    def __call__(self, boxes: np.ndarray, class_names: List[str],
                 scores: np.ndarray) -> List[str]:
        keep = [i for i in range(len(class_names))
                if scores[i] > 0 and class_names[i] not in BLACKLIST]
        boxes = boxes[keep] if len(boxes) else boxes
        class_names = [class_names[i] for i in keep]
        scores = scores[keep] if len(scores) else scores

        keep = self._nms(boxes, class_names)
        boxes = boxes[keep] if len(boxes) else boxes
        class_names = [class_names[i] for i in keep]
        scores = scores[keep] if len(scores) else scores

        pairs = sorted(zip(class_names, scores), key=lambda t: -t[1])
        pairs = pairs[: self._max_given_constraints]
        names = [REPLACEMENTS.get(c, c) for c, _ in pairs]
        return list(set(names))

    def _nms(self, boxes: np.ndarray, class_names: List[str]) -> List[int]:
        if len(class_names) == 0:
            return []
        heights = np.array([self._height(c) for c in class_names])
        order = heights.argsort()
        x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        areas = (x2 - x1 + 1) * (y2 - y1 + 1)
        keep: List[int] = []
        while order.size > 0:
            cur = order[0]
            keep.append(int(cur))
            xx1 = np.maximum(x1[cur], x1[order[1:]])
            yy1 = np.maximum(y1[cur], y1[order[1:]])
            xx2 = np.minimum(x2[cur], x2[order[1:]])
            yy2 = np.minimum(y2[cur], y2[order[1:]])
            inter = np.maximum(0.0, xx2 - xx1 + 1) * \
                np.maximum(0.0, yy2 - yy1 + 1)
            union = areas[cur] + areas[order[1:]] - inter
            cond = np.logical_or(heights[order[1:]] >= heights[cur],
                                 inter / union <= self._nms_threshold)
            order = order[1:][np.where(cond)[0]]
        return keep


def load_wordforms(path: str) -> Dict[str, List[str]]:
    """A TSV of `word<TAB>form,form,...` lines -> {word: [forms]} (the
    constraint-to-token and the wordform files)."""
    out: Dict[str, List[str]] = {}
    with open(path) as fp:
        for line in fp:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                out[parts[0]] = parts[1].split(",")
    return out


# ---------------------------------------------------------------------------
# FSM builders (host, numpy)
# ---------------------------------------------------------------------------

class FiniteStateMachineBuilder:
    """The dense (S, S, V) uint8 adjacency of a constraint set: 2^m main
    states (m = max_given_constraints; bit i set once constraint i is
    met) and max_words_per_constraint sub-states per main state for the
    words of multi-word constraints; S = 2^m x max_words_per_constraint."""

    def __init__(self, tokenizer, constraint2tokens: Dict[str, List[str]],
                 wordforms: Dict[str, List[str]],
                 max_given_constraints: int = 3,
                 max_words_per_constraint: int = 4):
        self._tokenizer = tokenizer
        self._constraint2tokens = constraint2tokens
        self._wordforms = wordforms
        self._max_given_constraints = max_given_constraints
        self._max_words_per_constraint = max_words_per_constraint
        self._num_main_states = 2 ** max_given_constraints
        self._num_total_states = self._num_main_states * \
            max_words_per_constraint

    def _words(self, constraint: str) -> List[str]:
        words: List[str] = []
        for w in constraint.split():
            words.extend(self._constraint2tokens.get(w, [w]))
        return words[: self._max_words_per_constraint]

    def _ids(self, word: str) -> List[int]:
        return self._tokenizer.convert_tokens_to_ids(
            self._wordforms.get(word, [word]))

    def build(self, constraints: List[str]) -> Tuple[np.ndarray, int]:
        """(the adjacency, the first unused sub-state)."""
        assert len(constraints) <= self._max_given_constraints
        S, V = self._num_total_states, self._tokenizer.vocab_size
        m = self._num_main_states
        fsm = np.zeros((S, S, V), dtype=np.uint8)
        fsm[range(m), range(m), :] = 1                # main self-loops
        substate_idx = m
        for i, c in enumerate(constraints):
            substate_idx = self._add_nth_constraint(
                lambda f, t, w, r: self._connect(fsm, f, t, w, r), i + 1,
                substate_idx, c)
        return fsm, substate_idx

    def _add_nth_constraint(self, connect, n, substate_idx, constraint):
        """Wire constraint n (1-based) into every main state without bit
        n - 1: its words chain through fresh sub-states to the main state
        with that bit set.  connect(from, to, word, reset_state)."""
        words = self._words(constraint)
        stride = 2 ** (n - 1)
        from_state = 0
        while from_state < self._num_main_states:
            for _ in range(stride):
                word_from = from_state
                for i, word in enumerate(words):
                    if i != len(words) - 1:
                        connect(word_from, substate_idx, word, from_state)
                        word_from = substate_idx
                        substate_idx += 1
                    else:
                        connect(word_from, from_state + stride, word,
                                from_state)
                from_state += 1
            from_state += stride
        return substate_idx

    def _connect(self, fsm, from_state, to_state, word, reset_state=None):
        ids = self._ids(word)
        for wi in ids:
            fsm[from_state, to_state, wi] = 1
            fsm[from_state, from_state, wi] = 0
        if reset_state is not None:
            # applied to main states too (reference utils_cbs.py:860-869):
            # it rewrites the whole self-loop row, which re-enables
            # self-loops for earlier constraints' wordforms; kept as the
            # reference does it
            fsm[from_state, from_state, :] = 0
            fsm[from_state, reset_state, :] = 1
            for wi in ids:
                fsm[from_state, reset_state, wi] = 0


class SparseFSM:
    """A compact FSM exactly equivalent to the dense (S, S, V) adjacency
    (`densify`): per state a default target (default_to, -1 for none) that
    receives the whole vocabulary but the `removed` words, plus exception
    edges (from, to, word).  Every row the builder writes decomposes so."""

    def __init__(self, S: int, V: int):
        self.S, self.V = S, V
        self.default_to = np.full(S, -1, np.int64)
        self.removed: List[set] = [set() for _ in range(S)]
        self.edges: set = set()              # (from, to, word)

    # the dense builder's operations
    def set1(self, f: int, t: int, w: int):
        if self.default_to[f] == t:
            self.removed[f].discard(w)
        else:
            self.edges.add((f, t, w))

    def set0(self, f: int, t: int, w: int):
        if self.default_to[f] == t:
            self.removed[f].add(w)
        self.edges.discard((f, t, w))

    def clear_row(self, f: int, t: int):
        if self.default_to[f] == t:
            self.default_to[f] = -1
            self.removed[f] = set()
        self.edges = {e for e in self.edges
                      if not (e[0] == f and e[1] == t)}

    def fill_row(self, f: int, t: int):
        # a full row subsumes any explicit edges into it
        self.default_to[f] = t
        self.removed[f] = set()
        self.edges = {e for e in self.edges
                      if not (e[0] == f and e[1] == t)}

    def densify(self) -> np.ndarray:
        fsm = np.zeros((self.S, self.S, self.V), np.uint8)
        for f in range(self.S):
            d = self.default_to[f]
            if d >= 0:
                fsm[f, d, :] = 1
                for w in self.removed[f]:
                    fsm[f, d, w] = 0
        for f, t, w in self.edges:
            fsm[f, t, w] = 1
        return fsm


def build_sparse_fsm(builder: FiniteStateMachineBuilder,
                     constraints: List[str]) -> SparseFSM:
    """FiniteStateMachineBuilder.build on SparseFSM's operations: the same
    adjacency (densify() equals build()[0]), no (S, S, V) array."""
    assert len(constraints) <= builder._max_given_constraints
    m = builder._num_main_states
    fsm = SparseFSM(builder._num_total_states, builder._tokenizer.vocab_size)
    fsm.default_to[:m] = np.arange(m)              # main self-loops

    def connect(from_state, to_state, word, reset_state):
        ids = builder._ids(word)
        for wi in ids:
            fsm.set1(from_state, to_state, wi)
            fsm.set0(from_state, from_state, wi)
        fsm.clear_row(from_state, from_state)
        fsm.fill_row(from_state, reset_state)
        for wi in ids:
            fsm.set0(from_state, reset_state, wi)

    substate_idx = m
    for n, c in enumerate(constraints, start=1):
        substate_idx = builder._add_nth_constraint(connect, n, substate_idx,
                                                   c)
    return fsm


def dense_to_sparse(fsm: np.ndarray) -> SparseFSM:
    """Any dense (S, S, V) adjacency in the default/removed/edges form: per
    source state, the target whose row covers more than half the vocab (if
    any) is the default; every other set bit is an exception edge."""
    S, _, V = fsm.shape
    sp = SparseFSM(S, V)
    for f in range(S):
        counts = fsm[f].sum(axis=1)
        d = int(counts.argmax())
        if counts[d] > V // 2:
            sp.default_to[f] = d
            sp.removed[f] = set(np.nonzero(fsm[f, d] == 0)[0].tolist())
        else:
            d = -1
        for t in range(S):
            if t == d:
                continue
            for w in np.nonzero(fsm[f, t])[0]:
                sp.edges.add((f, t, int(w)))
    return sp


def sparse_batch(fsms: Sequence[SparseFSM], pad_mult: int = 16
                 ) -> Dict[str, np.ndarray]:
    """Per-image SparseFSMs as padded int32 arrays: default_to (B, S),
    exc_from / exc_to / exc_word (B, E) and removed (B, S, R), -1 padded;
    E and R rounded up to multiples of pad_mult, so batches share a few
    shapes."""
    B = len(fsms)
    S = fsms[0].S

    def _pad(n):
        return max(pad_mult, -(-n // pad_mult) * pad_mult)

    E = _pad(max((len(f.edges) for f in fsms), default=1))
    R = _pad(max((max((len(r) for r in f.removed), default=0)
                  for f in fsms), default=1))
    default_to = np.stack([f.default_to for f in fsms]).astype(np.int32)
    exc = np.full((B, E, 3), -1, np.int32)
    removed = np.full((B, S, R), -1, np.int32)
    for b, f in enumerate(fsms):
        for i, (fr, to, w) in enumerate(sorted(f.edges)):
            exc[b, i] = (fr, to, w)
        for s, rw in enumerate(f.removed):
            removed[b, s, :len(rw)] = sorted(rw)
    return {"default_to": default_to, "exc_from": exc[:, :, 0],
            "exc_to": exc[:, :, 1], "exc_word": exc[:, :, 2],
            "removed": removed}


# ---------------------------------------------------------------------------
# top-k with lax.top_k's order
# ---------------------------------------------------------------------------

def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """int64 keys, one per element of the f32 x, whose descending order is
    x's descending order with ties to the lower index: the f32 bits made
    monotone (negative values' magnitude bits flipped; -0 counts as +0) in
    the high word, the reversed index in the low one.  All keys differ."""
    bits = (x.float() + 0.0).view(torch.int32)   # + 0.0: -0.0 -> +0.0
    flip = bits >> 31
    flip &= 0x7FFFFFFF
    bits ^= flip
    del flip
    keys = bits.long()
    del bits
    keys <<= 32
    N = x.shape[-1]
    keys += torch.arange(N - 1, -1, -1, device=x.device)
    return keys


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k over the last axis: the k largest values, descending,
    ties to the lower index, the indices distinct."""
    idx = torch.topk(_order_keys(x), k, dim=-1).indices
    return x.gather(-1, idx), idx


def exact_top_k_jax(x: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's decode.exact_top_k: top_k, except that each pick
    whose value is -inf (the row's finite values spent) returns index 0,
    as that function's k rounds of argmax over masked rows do."""
    vals, idx = top_k(x, k)
    return vals, torch.where(vals == NEG_INF, 0, idx)


# ---------------------------------------------------------------------------
# the searches (device)
# ---------------------------------------------------------------------------

def _step_logp(logits: torch.Tensor, prev: torch.Tensor, cfg: ModelConfig,
               decoding_constraint: bool, bad: Optional[torch.Tensor],
               filler: float) -> torch.Tensor:
    """f32 log-probabilities (Bb, V) of a search step: the previous token
    penalised by 1e20 under decoding_constraint; [SEP] penalised by 1e20
    after a bad ending word; a finished beam's row `filler` except [SEP],
    which is 0."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    sep = cfg.sep_token_id
    if decoding_constraint:
        col = prev[:, None]
        logp.scatter_(1, col, logp.gather(1, col) - 1e20)
    if bad is not None:
        pen = torch.isin(prev, bad)
        logp[:, sep] = torch.where(pen, logp[:, sep] - 1e20, logp[:, sep])
    finished = prev == sep
    logp.masked_fill_(finished[:, None], filler)
    logp[:, sep] = torch.where(finished, 0.0, logp[:, sep])
    return logp


def _search_setup(model, images, od_ids, od_token_type_ids, seq_len, cfg,
                  opts, B, G, ctx):
    """The shared context (built for B images unless given), the decode
    engine over B * G rows and its caches after the first (BOS) step, the
    token buffers (B, G, A) and the first step's f32 logits (B, G, V)."""
    if ctx is None:
        ctx = D.build_decode_context(model, images, od_ids,
                                     od_token_type_ids, seq_len, cfg, opts)
    dev = ctx["ctx_valid"].device
    A = opts.max_length
    init, step, reorder = D._decode_engine(model, ctx, cfg, opts, B * G)
    tokens = torch.full((B, G, A), cfg.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, :, 0] = cfg.cls_token_id
    logits, caches = step(init(), tokens[:, :, 0].reshape(B * G), 1)
    return ctx, dev, step, reorder, tokens, caches, \
        logits.float().view(B, G, -1)


def _reorder(tokens, caches, reorder, back, word, t):
    """Gather each beam's tokens and caches from its source beam back
    (B, G, within the image) and write its new word at slot t."""
    B, G, A = tokens.shape
    tokens = tokens.gather(1, back[..., None].expand(B, G, A))
    tokens[:, :, t] = word
    rows = torch.arange(B, device=back.device)[:, None] * G
    return tokens, reorder(caches, (rows + back).reshape(B * G))


@torch.inference_mode()
def constrained_beam_search(model, images: torch.Tensor,
                            od_ids: torch.Tensor,
                            od_token_type_ids: Optional[torch.Tensor],
                            seq_len: torch.Tensor, fsm: torch.Tensor,
                            cfg: ModelConfig, opts: D.DecodeOptions,
                            beam_size: int = 5,
                            decoding_constraint: bool = False,
                            bad_ending_ids: Optional[Sequence[int]] = None,
                            ctx: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, torch.Tensor]:
    """The dense search.  fsm: (B, S, S, V) uint8 (or bool) on the
    images' device.  Returns ids (B, S, beam_size, A), each state's beams
    by likelihood, position 0 BOS; logprobs (B, S, beam_size); tag_logits.
    Each step masks every beam's log-probabilities by every (from, to)
    row, a (B, S, S, beam_size, V) f32 block formed TOPK_CHUNK elements at
    a time; a small batch's search (the card runs B <= 2)."""
    A = opts.max_length
    nb = beam_size
    B, S, _, V = fsm.shape
    G = S * nb
    ctx, dev, step, reorder, tokens, caches, logits = _search_setup(
        model, images, od_ids, od_token_type_ids, seq_len, cfg, opts, B, G,
        ctx)
    allow = fsm.to(dev).bool()

    # first step: the BOS probe, transitions from state 0
    logp0 = torch.log_softmax(logits[:, 0], dim=-1)            # (B, V)
    start = torch.where(allow[:, 0], logp0[:, None, :], NEG_INF)  # (B, S, V)
    last_lp, first_tok = top_k(start, nb)                      # (B, S, nb)
    tokens[:, :, 1] = first_tok.reshape(B, G)
    bad = (torch.tensor(list(bad_ending_ids), device=dev)
           if bad_ending_ids else None)
    chunk = max(1, TOPK_CHUNK // (B * S * nb * V))

    for t in range(2, A):
        prev = tokens[:, :, t - 1].reshape(B * G)
        logits, caches = step(caches, prev, t)
        logp = _step_logp(logits, prev, cfg, decoding_constraint, bad,
                          NEG_INF).view(B, 1, S, nb, V)
        # per target state: mask by fsm[:, from, to, :], top beam_size per
        # (from, beam) over the vocab, add the running log-probability,
        # top beam_size over (from, beam, word)
        top_lp = torch.empty(B, S, S, nb, nb, device=dev)
        top_tok = torch.empty(B, S, S, nb, nb, dtype=torch.long, device=dev)
        for s0 in range(0, S, chunk):
            to = allow[:, :, s0:s0 + chunk].transpose(1, 2)   # (B,St,Sf,V)
            masked = torch.where(to[:, :, :, None, :], logp, STEP_MASK)
            top_lp[:, s0:s0 + chunk], top_tok[:, s0:s0 + chunk] = \
                exact_top_k_jax(masked, nb)
            del masked
        summed = top_lp + last_lp[:, None, :, :, None]
        last_lp, idx = top_k(summed.view(B, S, S * nb * nb), nb)
        word = top_tok.view(B, S, S * nb * nb).gather(2, idx)
        tokens, caches = _reorder(tokens, caches, reorder,
                                  (idx // nb).reshape(B, G),
                                  word.reshape(B, G), t)
    return {"ids": tokens.view(B, S, nb, A), "logprobs": last_lp,
            "tag_logits": ctx["tag_logits"]}


@torch.inference_mode()
def constrained_beam_search_sparse(
        model, images: torch.Tensor, od_ids: torch.Tensor,
        od_token_type_ids: Optional[torch.Tensor], seq_len: torch.Tensor,
        sfsm: Dict[str, torch.Tensor], cfg: ModelConfig,
        opts: D.DecodeOptions, beam_size: int = 5,
        decoding_constraint: bool = False,
        bad_ending_ids: Optional[Sequence[int]] = None,
        ctx: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The sparse search: sfsm holds sparse_batch's arrays as int64 tensors
    on the images' device.  The same beams as the dense search wherever a
    beam is live; dead beams score with the finite DEAD where the dense
    search has -inf.  Per step one top-K over the vocab per beam (K =
    beam_size + R: the R removed words of a row can cost at most R), then
    per target state the top beam_size of its candidates: the default
    flow of every beam and the exception edges from every source beam."""
    A = opts.max_length
    nb = beam_size
    default_to = sfsm["default_to"]                  # (B, S)
    exc_from, exc_to = sfsm["exc_from"], sfsm["exc_to"]   # (B, E)
    exc_word = sfsm["exc_word"]
    removed = sfsm["removed"]                        # (B, S, R)
    B, S = default_to.shape
    E, R = exc_from.shape[1], removed.shape[2]
    G = S * nb
    K = nb + R
    ctx, dev, step, reorder, tokens, caches, logits = _search_setup(
        model, images, od_ids, od_token_type_ids, seq_len, cfg, opts, B, G,
        ctx)
    exc_valid = exc_from >= 0
    exc_from_c = exc_from.clamp_min(0)
    exc_word_c = exc_word.clamp_min(0)
    exc_to_c = exc_to.clamp_min(0)
    states = torch.arange(S, device=dev)

    def pool_topk(scores, toks, targets, backs):
        """Per target state the top beam_size of the candidates (B, P)."""
        per_t = torch.where(targets[:, None, :] == states[None, :, None],
                            scores[:, None, :], DEAD)       # (B, S, P)
        new_lp, idx = top_k(per_t, nb)                      # (B, S, nb)
        flat = idx.view(B, S * nb)
        return (new_lp, toks.gather(1, flat).view(B, S, nb),
                backs.gather(1, flat).view(B, S, nb))

    # first step: the BOS probe, transitions from state 0
    logp0 = torch.log_softmax(logits[:, 0], dim=-1)          # (B, V)
    top_lp, top_tok = exact_top_k_jax(logp0, K)              # (B, K)
    rem0 = removed[:, 0]                                     # (B, R)
    hit = (top_tok[:, :, None] == rem0[:, None, :]) \
        & (rem0 >= 0)[:, None, :]
    d0 = default_to[:, 0]
    d_scores = torch.where(hit.any(-1) | (d0 < 0)[:, None], DEAD, top_lp)
    e_scores = torch.where(exc_valid & (exc_from == 0),
                           logp0.gather(1, exc_word_c), DEAD)
    last_lp, first_tok, _ = pool_topk(
        torch.cat([d_scores, e_scores], 1),
        torch.cat([top_tok, exc_word_c], 1),
        torch.cat([d0.clamp_min(0)[:, None].expand(B, K), exc_to_c], 1),
        torch.zeros(B, K + E, dtype=torch.long, device=dev))
    tokens[:, :, 1] = first_tok.reshape(B, G)

    bad = (torch.tensor(list(bad_ending_ids), device=dev)
           if bad_ending_ids else None)
    s_of_beam = torch.arange(G, device=dev) // nb
    beam_rm = removed[:, s_of_beam]                          # (B, G, R)
    beam_d = default_to[:, s_of_beam]                        # (B, G)
    d_targets = beam_d.clamp_min(0)[..., None].expand(B, G, K).reshape(B, -1)
    d_backs = torch.arange(G, device=dev)[None, :, None].expand(
        B, G, K).reshape(B, -1)
    # exception candidates: edge e from each source beam j of its state
    src = (exc_from_c[:, :, None] * nb
           + torch.arange(nb, device=dev)).reshape(B, E * nb)
    e_word = exc_word_c[:, :, None].expand(B, E, nb).reshape(B, E * nb)
    e_valid = exc_valid[:, :, None].expand(B, E, nb).reshape(B, E * nb)
    e_targets = exc_to_c[:, :, None].expand(B, E, nb).reshape(B, E * nb)
    rows = torch.arange(B, device=dev)[:, None]

    for t in range(2, A):
        prev = tokens[:, :, t - 1].reshape(B * G)
        logits, caches = step(caches, prev, t)
        logp = _step_logp(logits, prev, cfg, decoding_constraint, bad, DEAD)
        # one V-wide top-K per beam: the step's whole vocabulary cost
        top_lp, top_tok = exact_top_k_jax(logp, K)
        top_lp, top_tok = top_lp.view(B, G, K), top_tok.view(B, G, K)
        logp = logp.view(B, G, -1)
        # the default flow: beam (s, j) -> default_to[s]
        hit = (top_tok[..., None] == beam_rm[:, :, None, :]) \
            & (beam_rm >= 0)[:, :, None, :]                  # (B, G, K, R)
        d_scores = torch.where(hit.any(-1) | (beam_d < 0)[..., None], DEAD,
                               last_lp.view(B, G)[..., None] + top_lp)
        e_scores = torch.where(
            e_valid, last_lp.view(B, G).gather(1, src) + logp[rows, src,
                                                              e_word],
            DEAD)
        del logp
        last_lp, word, back = pool_topk(
            torch.cat([d_scores.view(B, -1), e_scores], 1),
            torch.cat([top_tok.view(B, -1), e_word], 1),
            torch.cat([d_targets, e_targets], 1),
            torch.cat([d_backs, src], 1))
        tokens, caches = _reorder(tokens, caches, reorder,
                                  back.reshape(B, G), word.reshape(B, G), t)
    return {"ids": tokens.view(B, S, nb, A), "logprobs": last_lp,
            "tag_logits": ctx["tag_logits"]}


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

class ConstraintBoxesReader:
    """Detected-boxes TSV: key -> {boxes, class_names, scores} (reference
    utils_cbs.py:458-489)."""

    def __init__(self, boxes_tsvpath: str):
        self._m: Dict[str, Dict[str, Any]] = {}
        with open(boxes_tsvpath) as fp:
            for line in fp:
                parts = line.strip().split("\t")
                labels = json.loads(parts[1])
                boxes = np.array([b["rect"] for b in labels]) \
                    if labels else np.zeros((0, 4))
                self._m[parts[0]] = {
                    "boxes": boxes,
                    "class_names": [b["class"].lower() for b in labels],
                    "scores": np.array([b["conf"] for b in labels]),
                }

    def __len__(self):
        return len(self._m)

    def __getitem__(self, key):
        return self._m.get(key, {"boxes": np.array([]), "class_names": [],
                                 "scores": np.array([])})


def put(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` (integers as int64).  To a CUDA device
    through pinned memory without blocking the host, so a search's inputs
    move while the card runs the previous batch."""
    if a.dtype.kind in "iu" and a.dtype != np.uint8:
        a = a.astype(np.int64)
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class CbsDecoder:
    """Per-image constraints -> FSM -> search on the device -> best beam.
    The FSM keeps the full num_total_states dimension (the reference trims
    unused sub-states per batch)."""

    def __init__(self, tokenizer, constraint_filter: ConstraintFilter,
                 fsm_builder: FiniteStateMachineBuilder,
                 boxes_reader: ConstraintBoxesReader,
                 min_constraints_to_satisfy: int = 2, beam_size: int = 5,
                 sparse: bool = True):
        self.tokenizer = tokenizer
        self.filter = constraint_filter
        self.builder = fsm_builder
        self.boxes = boxes_reader
        self.min_constraints = min_constraints_to_satisfy
        self.beam_size = beam_size
        self.sparse = sparse

    def _constraints(self, keys: Sequence[str]):
        out = []
        for k in keys:
            b = self.boxes[k]
            out.append(self.filter(b["boxes"], b["class_names"],
                                   b["scores"]))
        return out

    def build_batch_fsm(self, keys: Sequence[str]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        cons = self._constraints(keys)
        fsms = [self.builder.build(c)[0] for c in cons]
        return np.stack(fsms), np.asarray([len(c) for c in cons])

    def build_batch_fsm_sparse(self, keys: Sequence[str]
                               ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        cons = self._constraints(keys)
        fsms = [build_sparse_fsm(self.builder, c) for c in cons]
        return sparse_batch(fsms), np.asarray([len(c) for c in cons])

    def dispatch(self, model, images: torch.Tensor, od_ids: torch.Tensor,
                 od_tt: Optional[torch.Tensor], seq_len: torch.Tensor,
                 keys: Sequence[str], cfg: ModelConfig,
                 opts: D.DecodeOptions):
        """Build the batch's FSMs on the host and launch the search on the
        images' device without waiting for it: returns ((ids, logprobs) on
        the device, n_cons), so the caller can build the next batch while
        the card searches; collect() reads the results."""
        dev = images.device
        if self.sparse:
            sfsm, n_cons = self.build_batch_fsm_sparse(keys)
            out = constrained_beam_search_sparse(
                model, images, od_ids, od_tt, seq_len,
                {k: put(v, dev) for k, v in sfsm.items()}, cfg, opts,
                beam_size=self.beam_size)
        else:
            fsm, n_cons = self.build_batch_fsm(keys)
            out = constrained_beam_search(
                model, images, od_ids, od_tt, seq_len, put(fsm, dev), cfg,
                opts, beam_size=self.beam_size)
        return (out["ids"], out["logprobs"]), n_cons

    def collect(self, out, n_cons, cfg: ModelConfig
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Read the search's results back (waits for the device) and
        select each image's best constraint-satisfying beam."""
        ids, logprobs = out
        return select_best_beam_with_constraints(
            ids.cpu().numpy()[:, :, :, 1:], logprobs.cpu().numpy(), n_cons,
            self.min_constraints, [cfg.sep_token_id])

    def decode(self, model, images, od_ids, od_tt, seq_len, keys,
               cfg: ModelConfig, opts: D.DecodeOptions
               ) -> Tuple[np.ndarray, np.ndarray]:
        out, n_cons = self.dispatch(model, images, od_ids, od_tt, seq_len,
                                    keys, cfg, opts)
        return self.collect(out, n_cons, cfg)


def select_best_beam_with_constraints(
        beams: np.ndarray, beam_log_probabilities: np.ndarray,
        given_constraints: np.ndarray, min_constraints_to_satisfy: int,
        eos_token_ids: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Per image, the most likely top beam among the FSM states that meet
    at least min(given, min_to_satisfy) constraints, its log-probability
    divided by its length (reference utils_cbs.py:377-446)."""
    beams = np.asarray(beams)
    lps = np.asarray(beam_log_probabilities)
    B, num_states, beam_size, A = beams.shape
    best_b, best_lp = [], []
    for i in range(B):
        valid_states = [
            s for s in range(2 ** int(given_constraints[i]))
            if bin(s).count("1") >= min(int(given_constraints[i]),
                                        min_constraints_to_satisfy)]
        vb = beams[i, valid_states, 0, :]
        vlen = np.ones_like(vb)
        for eos in eos_token_ids:
            vlen = vlen * (vb != eos)
        vlen = vlen.sum(1) + 1
        vlp = lps[i, valid_states, 0] / vlen
        j = int(np.argmax(vlp))
        best_b.append(vb[j])
        best_lp.append(vlp[j])
    return np.stack(best_b), np.asarray(best_lp)
