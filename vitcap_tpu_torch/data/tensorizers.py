"""Text/tag tensorizers: caption MLM masking, seq2seq descriptors, multi-hot
tag labels; the port's copy of vitcap_tpu/data/tensorizers.py.

Re-implementation of the reference CaptionTensorizer.tensorize_ab
(ViTCAP src/data_layer/dataset.py:207-420, the live text-only path:
max_img_seq_length=0, with_img_feats=False) and CaptionTaggerTensorizer
(dataset.py:774-820).  Identical masking distribution: candidates are
positions 1..seq_a_len-1 inclusive of [SEP]; num_masked =
min(max(round(p*seq_a_len),1), max_masked); 80/10/10 mask/random/keep.

Instead of emitting the dense (max_seq, max_seq) attention matrix per
example (reference builds + collates a 70x70 int64 tensor), we emit the
compact (seq_a_len, seq_len) descriptors and the model builds the bias on
device (vitcap.seq2seq_text_mask).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from .tokenization import BertTokenizer


class CaptionTensorizer:
    def __init__(self, tokenizer: BertTokenizer, max_seq_length: int = 70,
                 max_seq_a_length: int = 40, mask_prob: float = 0.15,
                 max_masked_tokens: int = 3, mask_type: str = "seq2seq",
                 is_train: bool = True, mask_b: bool = False,
                 replace_by_mask_prob: float = 0.8,
                 replace_by_rand_prob: float = 0.1,
                 rng: Optional[random.Random] = None):
        assert mask_type in ("seq2seq", "seq2seq_off", "bidirectional")
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_length
        self.max_seq_a_len = max_seq_a_length
        self.mask_prob = mask_prob
        self.max_masked_tokens = max_masked_tokens
        self.mask_type = mask_type
        self.is_train = is_train
        self.mask_b = mask_b
        self.replace_by_mask_prob = replace_by_mask_prob
        self.replace_by_rand_prob = replace_by_rand_prob
        self.rng = rng or random.Random()

    def tensorize_ab(self, text_a: str, text_b: str = "",
                     real_text_a_in_test: bool = False) -> Dict[str, np.ndarray]:
        tok = self.tokenizer
        if not self.is_train and not real_text_a_in_test:
            tokens_a = [tok.mask_token] * (self.max_seq_a_len - 2)
        else:
            tokens_a = tok.tokenize(text_a)
        if len(tokens_a) > self.max_seq_a_len - 2:
            tokens_a = tokens_a[: self.max_seq_a_len - 2]
        tokens = [tok.cls_token] + tokens_a + [tok.sep_token]
        segment_ids = [0] * len(tokens)
        seq_a_len = len(tokens)
        seq_a_padded_len = seq_a_len
        if text_b:
            pad_a = self.max_seq_a_len - seq_a_len
            tokens += [tok.pad_token] * pad_a
            segment_ids += [0] * pad_a
            seq_a_padded_len = self.max_seq_a_len
            tokens_b = tok.tokenize(text_b)
            if len(tokens_b) > self.max_seq_len - len(tokens) - 1:
                tokens_b = tokens_b[: self.max_seq_len - len(tokens) - 1]
            tokens += tokens_b + [tok.sep_token]
            segment_ids += [1] * (len(tokens_b) + 1)
        seq_len = len(tokens)
        pad = self.max_seq_len - seq_len
        tokens = tokens + [tok.pad_token] * pad
        segment_ids += [0] * pad

        out: Dict[str, np.ndarray] = {}
        if self.is_train:
            masked_pos = np.zeros(self.max_seq_len, dtype=np.int32)
            if self.mask_b:
                cand = list(range(1, seq_a_len)) + \
                    list(range(seq_a_padded_len, seq_len))
                num = min(max(round(self.mask_prob * seq_len), 1),
                          self.max_masked_tokens)
            else:
                cand = list(range(1, seq_a_len))
                num = min(max(round(self.mask_prob * seq_a_len), 1),
                          self.max_masked_tokens)
            if self.mask_prob == 0:
                num = 0
            self.rng.shuffle(cand)
            masked_idx = sorted(cand[: int(num)])
            masked_token = [tokens[i] for i in masked_idx]
            for pos in masked_idx:
                if self.rng.random() <= self.replace_by_mask_prob:
                    tokens[pos] = tok.mask_token
                elif self.rng.random() <= self.replace_by_rand_prob / (
                        1 - self.replace_by_mask_prob):
                    tokens[pos] = self._random_token()
            masked_pos[masked_idx] = 1
            if len(masked_idx) < self.max_masked_tokens:
                masked_token += [tok.pad_token] * (
                    self.max_masked_tokens - len(masked_idx))
            out["masked_pos"] = masked_pos
            out["masked_ids"] = np.asarray(
                tok.convert_tokens_to_ids(masked_token), dtype=np.int32)

        out["input_ids"] = np.asarray(tok.convert_tokens_to_ids(tokens),
                                      dtype=np.int32)
        out["segment_ids"] = np.asarray(segment_ids, dtype=np.int32)
        out["seq_a_len"] = np.int32(seq_a_len)
        out["seq_len"] = np.int32(seq_len)
        return out

    def _random_token(self) -> str:
        # reference get_random_token (tokenization_bert.py:208): randint is
        # INCLUSIVE of vocab_size (off-by-one), which falls back to [UNK]
        i = self.rng.randint(0, self.tokenizer.vocab_size)
        if i >= self.tokenizer.vocab_size:
            return self.tokenizer.unk_token
        return self.tokenizer.convert_ids_to_tokens(i)


class CaptionTaggerTensorizer:
    """Multi-hot concept labels over the BERT vocab from detector classes
    (conf >= threshold, split on spaces, direct vocab lookup) plus caption
    words (nltk JJ/NN/NNP or all BERT wordpieces)
    (reference dataset.py:774-820)."""

    def __init__(self, bert_tokenizer: BertTokenizer, threshold: float = 0.2,
                 category: str = "bert", encode: str = "nltk",
                 caption_only: bool = False):
        assert category == "bert"
        assert encode in ("nltk", "bert", "precomputed")
        self.bert_tokenizer = bert_tokenizer
        self.threshold = threshold
        self.encode = encode
        self.caption_only = caption_only

    def tensorize(self, labels: List[dict],
                  caption: Optional[str] = None,
                  tag_words: Optional[List[str]] = None
                  ) -> Dict[str, np.ndarray]:
        """tag_words: offline-precomputed caption tag words
        (tools/precompute_tags.py) consumed when encode='precomputed' —
        replaces per-sample nltk work in the input pipeline hot path."""
        tok = self.bert_tokenizer
        label = np.zeros(tok.vocab_size, dtype=np.float32)
        if not self.caption_only:
            for tag in labels:
                if tag.get("conf", 1.0) >= self.threshold:
                    for t in tag["class"].split(" "):
                        label[tok.convert_tokens_to_ids(t)] = 1
        if self.encode == "precomputed":
            if tag_words is None and caption is not None:
                raise ValueError(
                    "encode='precomputed' but the sample has no "
                    "caption_tags — run tools/precompute_tags.py and make "
                    "sure LoadCaptionTags is in the transform chain")
            for word in tag_words or []:
                for t in word.split(" "):
                    label[tok.convert_tokens_to_ids(t)] = 1
        elif caption is not None:
            if self.encode == "nltk":
                for word, pos in pos_tag_caption(caption):
                    if pos in ("JJ", "NN", "NNP"):
                        for t in word.split(" "):
                            label[tok.convert_tokens_to_ids(t)] = 1
            elif self.encode == "bert":
                for i in tok.encode(caption):
                    label[i] = 1
        return {"label": label}


class VinvlTaggerTensorizer:
    """AllTaggerTensorizer: multi-hot over the vinvl detector vocab
    (reference dataset.py:823-843; yaml/vinvl_label.json, 2027 classes)."""

    def __init__(self, label_to_idx: Dict[str, int], threshold: float = 0.2):
        self.label_to_idx = label_to_idx
        self.threshold = threshold

    def tensorize(self, labels: List[dict],
                  caption: Optional[str] = None,
                  tag_words: Optional[List[str]] = None
                  ) -> Dict[str, np.ndarray]:
        label = np.zeros(len(self.label_to_idx), dtype=np.float32)
        for tag in labels:
            if tag.get("conf", 1.0) >= self.threshold:
                label[self.label_to_idx[tag["class"]]] = 1
        return {"label": label}


def pos_tag_caption(caption: str):
    """nltk word_tokenize + pos_tag when the models are available; otherwise
    a whitespace/punct fallback tagging every token NN (caption nouns are the
    dominant signal; offline environments lack the perceptron model)."""
    try:
        import nltk
        return nltk.pos_tag(nltk.word_tokenize(caption))
    except Exception:
        import re
        words = re.findall(r"[A-Za-z']+", caption)
        return [(w, "NN") for w in words]
