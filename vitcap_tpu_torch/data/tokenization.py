"""BERT WordPiece tokenizer (self-contained, no external deps), the port's
copy of vitcap_tpu/data/tokenization.py.  CaptionDecoder, the decode
half serving uses, is BertTokenizer over the shipped vocab by default.

Behavioral reference: ViTCAP src/layers/bert/tokenization_bert.py
(BertTokenizer :88, BasicTokenizer :254, WordpieceTokenizer :385).  Vocab file format: one token per line, id = line
number (DEFAULT_VOCAB, 30522 tokens).
"""

from __future__ import annotations

import os.path as op
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional

# the vocab shipped with the repo (30522 tokens, id = line number)
DEFAULT_VOCAB = (Path(__file__).resolve().parents[1] / "assets"
                 / "VILT-L12-H784-uncased_16_384" / "vocab.txt")

SPECIAL_TOKENS = ("[CLS]", "[SEP]", "[PAD]", "[MASK]")


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as fp:
        for idx, line in enumerate(fp):
            token = line.rstrip("\n")
            vocab[token] = idx
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting + lowercasing + accent stripping."""

    def __init__(self, do_lower_case: bool = True,
                 never_split: Optional[Iterable[str]] = None):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split or
                               ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]"))

    def tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        tokens: List[str] = []
        for tok in text.split():
            if tok in self.never_split:
                tokens.append(tok)
                continue
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_on_punc(tok))
        return " ".join(tokens).split()

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _tokenize_chinese_chars(text: str) -> str:
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(text: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in text:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]


class WordpieceTokenizer:
    """Greedy longest-match-first subword tokenization."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for token in text.split():
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            is_bad = False
            start = 0
            sub_tokens: List[str] = []
            while start < len(chars):
                end = len(chars)
                cur = None
                while start < end:
                    substr = "".join(chars[start:end])
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur = substr
                        break
                    end -= 1
                if cur is None:
                    is_bad = True
                    break
                sub_tokens.append(cur)
                start = end
            out.extend([self.unk_token] if is_bad else sub_tokens)
        return out


class BertTokenizer:
    cls_token = "[CLS]"
    sep_token = "[SEP]"
    pad_token = "[PAD]"
    mask_token = "[MASK]"
    unk_token = "[UNK]"

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        if not op.isfile(vocab_file):
            raise FileNotFoundError(vocab_file)
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic_tokenizer = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece_tokenizer = WordpieceTokenizer(self.vocab,
                                                      self.unk_token)


    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic_tokenizer.tokenize(text):
            if tok in self.vocab and tok in self.basic_tokenizer.never_split:
                out.append(tok)
            else:
                out.extend(self.wordpiece_tokenizer.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.vocab[self.unk_token])
        return [self.vocab.get(t, self.vocab[self.unk_token]) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> List[str]:
        if isinstance(ids, int):
            return self.ids_to_tokens[ids]
        return [self.ids_to_tokens[int(i)] for i in ids]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode(self, token_ids, skip_special_tokens: bool = True) -> str:
        specials = set(SPECIAL_TOKENS) if skip_special_tokens else set()
        toks = []
        for i in token_ids:
            t = self.ids_to_tokens.get(int(i), self.unk_token)
            if t in specials:
                continue
            toks.append(t)
        text = " ".join(toks).replace(" ##", "").strip()
        return text


class CaptionDecoder(BertTokenizer):
    """ids -> text over the shipped vocab by default: special tokens
    dropped, WordPiece '##' pieces joined (BertTokenizer.decode)."""

    def __init__(self, vocab_file=DEFAULT_VOCAB):
        super().__init__(str(vocab_file))
