"""Text cut methods cut0..cut5 + big-text splitting.

A copy of gpt_sovits_tpu/text/segmentation.py.

Counterpart of reference TTS_infer_pack/text_segmentation_method.py:90-184
and TextPreprocessor.split_big_text (510-char BERT cap).
"""

from __future__ import annotations

import re
from typing import Callable

SPLITS = set("，。？！,.?!~:：—…")

_METHODS: dict[str, Callable[[str], list[str]]] = {}


def register(name: str):
    def deco(fn):
        _METHODS[name] = fn
        return fn

    return deco


def get_method(name: str) -> Callable[[str], list[str]]:
    if name not in _METHODS:
        raise ValueError(f"unknown cut method {name!r}; have {sorted(_METHODS)}")
    return _METHODS[name]


def _strip_empty(parts: list[str]) -> list[str]:
    return [p for p in parts if p.strip() and not all(c in SPLITS for c in p.strip())]


def split_sentences(text: str) -> list[str]:
    """Split at sentence punctuation, keeping the delimiter (ref split())."""
    text = text.strip("\n")
    out = []
    cur = []
    for ch in text:
        cur.append(ch)
        if ch in SPLITS:
            out.append("".join(cur))
            cur = []
    if cur:
        out.append("".join(cur))
    return _strip_empty(out)


@register("cut0")
def cut0(text: str) -> list[str]:
    """No cut."""
    return _strip_empty([text])


@register("cut1")
def cut1(text: str) -> list[str]:
    """Batches of 4 sentences."""
    sents = split_sentences(text)
    return _strip_empty(["".join(sents[i : i + 4]) for i in range(0, len(sents), 4)])


@register("cut2")
def cut2(text: str) -> list[str]:
    """Batches of ~50 chars."""
    sents = split_sentences(text)
    out, cur, count = [], [], 0
    for s in sents:
        cur.append(s)
        count += len(s)
        if count > 50:
            out.append("".join(cur))
            cur, count = [], 0
    if cur:
        # merge a short tail into the previous chunk (ref cut2 behavior)
        if out and count < 50:
            out[-1] += "".join(cur)
        else:
            out.append("".join(cur))
    return _strip_empty(out)


@register("cut3")
def cut3(text: str) -> list[str]:
    """Split at Chinese full stop."""
    return _strip_empty([p + "。" for p in text.strip("。").split("。") if p])


@register("cut4")
def cut4(text: str) -> list[str]:
    """Split at English full stop (not decimals)."""
    return _strip_empty(re.split(r"(?<!\d)\.(?!\d)", text.strip(".")))


@register("cut5")
def cut5(text: str) -> list[str]:
    """Split at every sentence punctuation mark."""
    return split_sentences(text)


def split_big_text(text: str, max_len: int = 510) -> list[str]:
    """Hard cap segments for the BERT 512-token window
    (ref TextPreprocessor.split_big_text)."""
    if len(text) <= max_len:
        return [text]
    out, cur = [], []
    for piece in split_sentences(text) or [text]:
        if sum(map(len, cur)) + len(piece) > max_len and cur:
            out.append("".join(cur))
            cur = []
        while len(piece) > max_len:
            out.append(piece[:max_len])
            piece = piece[max_len:]
        cur.append(piece)
    if cur:
        out.append("".join(cur))
    return out
