"""Cantonese (yue) g2p: hanzi -> jyutping -> Y-prefixed phones.

A copy of gpt_sovits_tpu/text/cantonese.py with its data files.

Counterpart of GPT_SoVITS/text/cantonese.py: text normalization shares the
zh pipeline, hanzi->jyutping comes from the ToJyutping lexicon when that
package is importable, else from a user-supplied char->jyutping TSV, else
from the bundled frequent-hanzi table (data/yue_jyutping.json.gz,
generated by scripts/gen_yue_data.py: curated char readings + word-level
polyphone entries, longest-match segmentation). Jyutping syllables split
into initial + tone-carrying final, each prefixed with "Y" to keep the
yue phone space disjoint from Mandarin in the v2 symbol table
(reference cantonese.py:163-175).
"""

from __future__ import annotations

import functools
import gzip
import json
import os
import re
from typing import Optional

from gpt_sovits_tpu_torch.text.zh_norm import normalize_zh

PUNCT = ("!", "?", "…", ",", ".", "-")

_REP_MAP = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?", "\n": ".",
    "·": ",", "、": ",", "...": "…", "$": ".", "“": "'", "”": "'", '"': "'",
    "‘": "'", "’": "'", "（": "'", "）": "'", "(": "'", ")": "'", "《": "'",
    "》": "'", "【": "'", "】": "'", "[": "'", "]": "'", "—": "-", "～": "-",
    "~": "-", "「": "'", "」": "'",
}

# onset list in the reference's iteration order (cantonese.py:13-55 —
# first match in WRITTEN order, so "aa" wins over "aai"); includes
# whole-syllable "onsets" so vowel-onset syllables split as (onset, tail)
_REF_ORDER = [
    "aa", "aai", "aak", "aap", "aat", "aau", "ai", "au", "ap", "at", "ak", "a",
    "p", "b", "e", "ts", "t", "dz", "d", "kw", "k", "gw", "g", "f", "h", "l",
    "m", "ng", "n", "s", "y", "w", "c", "z", "j",
    "ong", "on", "ou", "oi", "ok", "o", "uk", "ung", "sp", "spl", "spn", "sil",
]


def replace_punctuation(text: str) -> str:
    pattern = re.compile("|".join(re.escape(p) for p in _REP_MAP))
    text = pattern.sub(lambda m: _REP_MAP[m.group()], text)
    return re.sub(r"[^一-龥" + re.escape("".join(PUNCT)) + r"]+", "", text)


def text_normalize(text: str) -> str:
    return replace_punctuation(normalize_zh(text))


def jyutping_to_phones(syllables: list[str]) -> tuple[list[str], list[int]]:
    """jyutping (or punctuation) items -> (phones, word2ph).

    Splits each syllable at the first matching onset from the reference's
    list (first match in ITS order, not longest), carries the tone on the
    final, prefixes non-punctuation phones with "Y"
    (reference jyuping_to_initials_finals_tones:117-175).
    """
    phones: list[str] = []
    word2ph: list[int] = []
    punct = set(PUNCT)
    for syllable in syllables:
        for part in syllable.split():
            if part in punct or part == "_":
                phones.append(part)
                word2ph.append(1)
                continue
            if part[-1].isdigit():
                tone, bare = int(part[-1]), part[:-1]
            else:
                tone, bare = 0, part
            for initial in _REF_ORDER:
                if bare.startswith(initial):
                    if bare.startswith("nga"):
                        ini, fin = bare[:2], bare[2:] or bare[-1]
                    else:
                        ini, fin = initial, bare[len(initial) :] or initial[-1]
                    a = f"Y{ini}"
                    b = f"Y{fin}{tone}" if tone != 0 else f"Y{fin}"
                    phones.extend([a, b])
                    word2ph.append(2)
                    break
    return phones, word2ph


_LEXICON: Optional[dict] = None


def _load_lexicon() -> Optional[dict]:
    """Optional char->jyutping TSV (one `char\\tjyutping` per line),
    pointed to by GPT_SOVITS_JYUTPING_LEXICON."""
    global _LEXICON
    path = os.environ.get("GPT_SOVITS_JYUTPING_LEXICON")
    if _LEXICON is None and path and os.path.exists(path):
        _LEXICON = {}
        for line in open(path, encoding="utf-8"):
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                _LEXICON[parts[0]] = parts[1]
    return _LEXICON


def get_jyutping(text: str) -> list[str]:
    """text -> per-word jyutping strings / punctuation items."""
    punct_re = re.compile(r"^[{}]+$".format(re.escape("".join(PUNCT))))
    try:
        import ToJyutping  # external lexicon package

        out = []
        for word, syllable in ToJyutping.get_jyutping_list(text):
            if punct_re.match(word):
                out.extend(p for p in re.split(r"([{}])".format(re.escape("".join(PUNCT))), word) if p)
            else:
                if not re.search(r"^([a-z]+[1-6]+[ ]?)+$", syllable or ""):
                    raise ValueError(f"cannot convert {word!r} to jyutping: {syllable!r}")
                out.append(syllable)
        return out
    except ImportError:
        lex = _load_lexicon()
        if lex is not None:
            from gpt_sovits_tpu_torch.text.zh_norm import traditional_variants_table

            variants = traditional_variants_table()
            out = []
            for ch in text:
                if punct_re.match(ch):
                    out.append(ch)
                elif ch in lex:
                    out.append(lex[ch])
                else:
                    # TN simplifies hanzi; user lexicons are usually keyed
                    # on traditional forms — retry every traditional variant
                    for trad in variants.get(ch, ""):
                        if trad in lex:
                            out.append(lex[trad])
                            break
            return out
        return _builtin_jyutping(text, punct_re)


@functools.lru_cache(maxsize=1)
def _builtin_lexicon() -> dict:
    path = os.path.join(os.path.dirname(__file__), "data", "yue_jyutping.json.gz")
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def _builtin_jyutping(text: str, punct_re: re.Pattern) -> list[str]:
    """Longest-match over the bundled word + char jyutping tables."""
    from gpt_sovits_tpu_torch.text.zh_norm import traditional_variants_table

    lex = _builtin_lexicon()
    words, chars = lex["words"], lex["chars"]
    variants = traditional_variants_table()
    max_len = max(map(len, words))
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        for ln in range(min(max_len, n - i), 1, -1):
            w = text[i : i + ln]
            if w in words:
                out.append(words[w])
                i += ln
                break
        else:
            ch = text[i]
            if punct_re.match(ch):
                out.append(ch)
            elif ch in words:
                out.append(words[ch])
            elif ch in chars:
                out.append(chars[ch])
            else:
                # try traditional variants of a simplified char (and back)
                for var in variants.get(ch, ""):
                    if var in chars:
                        out.append(chars[var])
                        break
            i += 1
    return out


def g2p(text: str) -> tuple[list[str], list[int]]:
    return jyutping_to_phones(get_jyutping(text))


def clean_text_yue(text: str) -> tuple[list[str], list[int], str]:
    norm = text_normalize(text)
    phones, word2ph = g2p(norm)
    return phones, word2ph, norm
