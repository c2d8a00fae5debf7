"""WordPiece tokenizer of the BERT text features (the port's own).

The JAX package takes chinese-roberta's tokenizer from `transformers`
(gpt_sovits_tpu/utils/loaders.py `load_bert`); the port does not depend on
`transformers`, so it carries the part of `BertTokenizer` that the
pipeline and g2pW call, with its rules:

  * clean: drop NUL, U+FFFD and control characters, map whitespace to " ";
  * put spaces around every CJK ideograph, NFC-normalize, split on
    whitespace;
  * lower-case and strip accents (NFD, drop combining marks) when
    `do_lower_case`; split off every punctuation character (ASCII symbols
    and Unicode category P);
  * greedy longest-match-first WordPiece with "##" continuations; a word
    with no cover, or longer than 100 characters, becomes [UNK].

Special tokens ([CLS], [SEP], [PAD], [UNK], [MASK]) in the text stay whole.
Its surface: `__call__(text, return_tensors="np") -> {"input_ids"}` with
[CLS] ... [SEP], `tokenize`, `convert_tokens_to_ids`.
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import Iterable, Union

import numpy as np

SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
UNK = "[UNK]"
MAX_WORD_CHARS = 100
_CJK = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class BertTokenizer:
    """vocab: a `vocab.txt` path (one token a line, its id the line number)
    or a sequence of tokens in id order."""

    def __init__(self, vocab: Union[str, os.PathLike, Iterable[str]], do_lower_case: bool = True):
        if isinstance(vocab, (str, os.PathLike)):
            with open(vocab, encoding="utf-8") as f:
                vocab = [line.rstrip("\n") for line in f.readlines()]
        self.vocab: dict[str, int] = {}
        for i, tok in enumerate(vocab):
            self.vocab[tok] = i  # a repeated token keeps its last id, as transformers' load_vocab
        self.do_lower_case = do_lower_case
        specials = [t for t in SPECIAL if t in self.vocab]
        self._special_re = re.compile("(" + "|".join(map(re.escape, specials)) + ")") if specials else None

    def __len__(self) -> int:
        return len(self.vocab)

    # -- basic tokenization -------------------------------------------------

    def _basic(self, text: str) -> list[str]:
        text = "".join(
            " " if _is_whitespace(ch) else ch
            for ch in text if not (ord(ch) in (0, 0xFFFD) or _is_control(ch))
        )
        text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
        out: list[str] = []
        for tok in unicodedata.normalize("NFC", text).split():
            if self.do_lower_case:
                tok = "".join(c for c in unicodedata.normalize("NFD", tok.lower()) if unicodedata.category(c) != "Mn")
            word = ""
            for ch in tok:
                if _is_punctuation(ch):
                    if word:
                        out.append(word)
                    out.append(ch)
                    word = ""
                else:
                    word += ch
            if word:
                out.append(word)
        return out

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > MAX_WORD_CHARS:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                sub = ("##" if start else "") + word[start:end]
                if sub in self.vocab:
                    break
                end -= 1
            if end == start:
                return [UNK]
            pieces.append(sub)
            start = end
        return pieces

    # -- the surface the pipeline and g2pW call ------------------------------

    def tokenize(self, text: str) -> list[str]:
        parts = self._special_re.split(text) if self._special_re is not None else [text]
        out: list[str] = []
        for i, part in enumerate(parts):
            if i % 2:  # a special token, kept whole
                out.append(part)
                continue
            for word in self._basic(part):
                out.extend(self._wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens):
        unk = self.vocab.get(UNK)
        if isinstance(tokens, str):
            return self.vocab.get(tokens, unk)
        return [self.vocab.get(t, unk) for t in tokens]

    def __call__(self, text: str, return_tensors: str = "np") -> dict:
        if return_tensors != "np":
            raise ValueError(f"return_tensors={return_tensors!r}: only 'np'")
        ids = self.convert_tokens_to_ids(["[CLS]"] + self.tokenize(text) + ["[SEP]"])
        return {"input_ids": np.asarray([ids], np.int64)}
