"""Caption text from token ids: the decode half of the BERT WordPiece
tokenizer (vitcap_tpu.data.tokenization.BertTokenizer.decode), reading the
same vocab file.  Kept in the port so that serving imports nothing of the
JAX package; a test holds it against the JAX package's tokenizer.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

# the vocab shipped with the repo (30522 tokens, id = line number)
DEFAULT_VOCAB = (Path(__file__).resolve().parents[2] / "vitcap_tpu" / "assets"
                 / "VILT-L12-H784-uncased_16_384" / "vocab.txt")

SPECIAL_TOKENS = ("[CLS]", "[SEP]", "[PAD]", "[MASK]")


class CaptionDecoder:
    """ids -> text: special tokens dropped, WordPiece '##' pieces joined."""

    def __init__(self, vocab_file=DEFAULT_VOCAB):
        with open(vocab_file, "r", encoding="utf-8") as fp:
            self.ids_to_tokens = {i: line.rstrip("\n")
                                  for i, line in enumerate(fp)}

    def decode(self, token_ids: Iterable[int],
               skip_special_tokens: bool = True) -> str:
        specials = set(SPECIAL_TOKENS) if skip_special_tokens else set()
        toks = [self.ids_to_tokens.get(int(i), "[UNK]") for i in token_ids]
        toks = [t for t in toks if t not in specials]
        return " ".join(toks).replace(" ##", "").strip()
