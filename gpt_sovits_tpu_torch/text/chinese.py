"""Chinese g2p: hanzi -> word-level pinyin -> v2 phone symbols.

A copy of gpt_sovits_tpu/text/chinese.py with its data files.

Counterpart of reference text/chinese2.py (pypinyin + g2pW + tone sandhi +
erhua). Fully self-contained: hanzi->pinyin runs on a built-in lexicon
(data/zh_pinyin.json.gz — ~45k word readings from the reference's
polyphone-correction dictionary plus per-character defaults; generated by
scripts/gen_zh_data.py), segmented with jieba (ships in the image), with
the g2pW ONNX model as an optional overlay (text/g2pw.py) exactly like the
reference's correct_pronunciation flow (chinese2.py:207-242).

The pinyin -> phone-symbol step goes through the v2 syllable table
(data/zh_pinyin_symbols.json.gz, the reference's opencpop-strict.txt):
every syllable maps to exactly (initial, final+tone) — zero-initial
syllables use pseudo-initials (AA/EE/OO/y/w), apical vowels split as
zh/ch/sh/r+"ir" vs z/c/s+"i0" (chinese2.py:244-292).
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import re
from functools import lru_cache

log = logging.getLogger(__name__)

PUNCT = set("!?…,.-")

_PUNC_MAP = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "·": ",", "、": ",", "...": "…", "$": ".", "/": ",",
    "—": "-", "~": "…", "～": "…",
}

# ---------------------------------------------------------------------------
# lexicon data
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _lexicon() -> tuple[dict, dict]:
    path = os.path.join(os.path.dirname(__file__), "data", "zh_pinyin.json.gz")
    with gzip.open(path, "rt", encoding="utf-8") as f:
        d = json.load(f)
    return d["words"], d["chars"]


@lru_cache(maxsize=1)
def _syllable_table() -> dict[str, list[str]]:
    path = os.path.join(os.path.dirname(__file__), "data", "zh_pinyin_symbols.json.gz")
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# pinyin -> phones (v2 symbol convention)
# ---------------------------------------------------------------------------

_INITIALS = [
    "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "r", "z", "c", "s", "y", "w",
]

_VALID_FINALS = {
    "a", "o", "e", "i", "u", "v", "ai", "ei", "ao", "ou", "an", "en", "ang",
    "eng", "er", "ia", "ie", "iao", "iou", "ian", "in", "iang", "ing",
    "iong", "ua", "uo", "uai", "uei", "uan", "uen", "uang", "ueng", "ong",
    "ve", "van", "vn", "ir", "E", "o2",
}


def split_pinyin(syllable: str) -> tuple[str, str]:
    """'zhong1' -> ('zh', 'ong1'); 'an4' -> ('', 'an4').

    Algorithmic decomposition with standard orthographic restorations
    (yu->v, iu->iou, ui->uei, un->uen, apical i->ir). Used as the fallback
    for syllables outside the v2 table; `syllable_to_phones` (the table
    path) is the production route."""
    m = re.fullmatch(r"([a-zvü]+)([1-5])?", syllable.lower())
    if not m:
        raise ValueError(f"bad pinyin syllable: {syllable!r}")
    body, tone = m.group(1), m.group(2) or "5"
    body = body.replace("ü", "v")
    initial = ""
    for ini in _INITIALS:
        if body.startswith(ini):
            initial = ini
            body = body[len(ini) :]
            break
    if initial in ("j", "q", "x", "y") and body.startswith("u"):
        body = "v" + body[1:]
    if initial and body == "iu":
        body = "iou"
    if initial and body == "ui":
        body = "uei"
    if initial and body == "un" and initial not in ("y",):
        body = "uen"
    if initial in ("zh", "ch", "sh", "r", "z", "c", "s") and body == "i":
        body = "ir"
    if body not in _VALID_FINALS:
        pass  # keep as-is (UNK mapping downstream)
    return initial, body + tone


def syllable_to_phones(syllable: str) -> list[str]:
    """Toned pinyin -> [initial-symbol, final-symbol+tone] via the v2 table
    (exactly the reference's opencpop-strict lookup)."""
    m = re.fullmatch(r"([a-zvü:]+)([1-5])?", syllable.lower())
    if not m:
        raise ValueError(f"bad pinyin syllable: {syllable!r}")
    body, tone = m.group(1).replace("ü", "v").replace("u:", "v"), m.group(2) or "5"
    hit = _syllable_table().get(body)
    if hit is None:
        ini, fin = split_pinyin(body + tone)
        return [ini, fin] if ini else [fin]
    ini, fin = hit
    return [ini, fin + tone]


def pinyin_to_phones(syllables: list[str]) -> tuple[list[str], list[int]]:
    """List of toned pinyin / punctuation marks -> (phones, word2ph)."""
    phones: list[str] = []
    word2ph: list[int] = []
    for syl in syllables:
        if syl in PUNCT or syl in _PUNC_MAP.values():
            phones.append(syl if syl else ",")
            word2ph.append(1)
            continue
        ph = syllable_to_phones(syl)
        phones.extend(ph)
        word2ph.append(len(ph))
    return phones, word2ph


# ---------------------------------------------------------------------------
# hanzi -> pinyin (word level)
# ---------------------------------------------------------------------------

_HANZI_RUN = re.compile(r"[一-龥]")

# erhua: words that must / must not merge a trailing 儿 into the previous
# syllable (reference chinese2.py:93-139, linguistic data)
_MUST_ERHUA = {"小院儿", "胡同儿", "范儿", "老汉儿", "撒欢儿", "寻老礼儿", "妥妥儿", "媳妇儿"}
_NOT_ERHUA = {
    "虐儿", "为儿", "护儿", "瞒儿", "救儿", "替儿", "有儿", "一儿", "我儿",
    "俺儿", "妻儿", "拐儿", "聋儿", "乞儿", "患儿", "幼儿", "孤儿", "婴儿",
    "婴幼儿", "连体儿", "脑瘫儿", "流浪儿", "体弱儿", "混血儿", "蜜雪儿",
    "舫儿", "祖儿", "美儿", "应采儿", "可儿", "侄儿", "孙儿", "侄孙儿",
    "女儿", "男儿", "红孩儿", "花儿", "虫儿", "马儿", "鸟儿", "猪儿",
    "猫儿", "狗儿", "少儿",
}


def _merge_erhua(word: str, pos: str, sylls: list[str]) -> list[str]:
    """Rhotacization: trailing 儿 reads as 'er'+previous tone when the word
    is an erhua form (reference _merge_erhua, chinese2.py:142-177)."""
    if len(sylls) != len(word):
        return sylls
    # final-儿 in a word always reads er2, not er1
    if word and word[-1] == "儿" and sylls and sylls[-1] == "er1":
        sylls = sylls[:-1] + ["er2"]
    if word not in _MUST_ERHUA and (word in _NOT_ERHUA or pos in ("a", "j", "nr")):
        return sylls
    out = list(sylls)
    if (
        len(word) >= 2
        and word[-1] == "儿"
        and out[-1] in ("er2", "er5")
        and word[-2:] not in _NOT_ERHUA
    ):
        out[-1] = "er" + out[-2][-1]
    return out


def _word_pinyin(word: str, g2pw_base: list[str] | None = None) -> list[str]:
    """Toned pinyin per char of a hanzi word: word-lexicon hit beats the
    g2pW overlay beats per-char defaults (chinese2.py correct_pronunciation).
    Compounds outside the lexicon are covered greedily by their longest
    in-lexicon sub-words (银行行长 -> 银行 + ...), which the reference's
    per-word pypinyin lookup also does via its phrase dictionary.
    Characters with no reading are dropped (empty string placeholder)."""
    words, chars = _lexicon()
    hit = words.get(word)
    if hit is not None:
        return list(hit)

    out: list[str] = []
    i = 0
    while i < len(word):
        if len(word) - i >= 2:  # longest in-lexicon sub-word at this offset
            sub = None
            for j in range(len(word), i + 1, -1):
                sub = words.get(word[i:j])
                if sub is not None:
                    out.extend(sub)
                    i = j
                    break
            if sub is not None:
                continue
        ch = word[i]
        if g2pw_base is not None and g2pw_base[i]:
            out.append(g2pw_base[i])
        else:
            py = chars.get(ch)
            if py is None:
                if _HANZI_RUN.search(ch):
                    log.warning("no pinyin reading for %r; dropping", ch)
                py = ""
            out.append(py)
        i += 1
    return out


def _segment_words(seg: str) -> list[tuple[str, str]]:
    """jieba.posseg + the sandhi pre-merge (ref pre_merge_for_modify)."""
    from gpt_sovits_tpu_torch.text.tone_sandhi import _pre_merge

    try:
        import jieba.posseg as pseg

        words = [(w, p) for w, p in pseg.lcut(seg)]
    except Exception:
        words = [(c, "x") for c in seg]
    return _pre_merge(words)


def _g2pw_segment(seg: str) -> list[str] | None:
    """Per-char pinyin for a segment from the g2pW ONNX model when active."""
    from gpt_sovits_tpu_torch.text import g2pw

    model = g2pw.active()
    if model is None:
        return None
    try:
        words, chars = _lexicon()
        base = [chars.get(c, "") for c in seg]
        return model.correct(seg, base)
    except Exception:
        return None


def _g2p_segment(seg: str) -> tuple[list[str], list[str]]:
    """One punctuation-terminated segment -> (kept_chars, syllables)."""
    from gpt_sovits_tpu_torch.text.tone_sandhi import modified_tone

    seg = re.sub("[a-zA-Z]+", "", seg)
    g2pw_base = _g2pw_segment(seg) if _HANZI_RUN.search(seg) else None
    kept: list[str] = []
    sylls: list[str] = []
    offset = 0
    for word, pos in _segment_words(seg):
        start = offset
        offset += len(word)
        if not _HANZI_RUN.search(word):
            for ch in word:
                if ch in PUNCT:
                    kept.append(ch)
                    sylls.append(ch)
            continue
        base = g2pw_base[start : start + len(word)] if g2pw_base else None
        wp = _word_pinyin(word, base)
        wp = modified_tone(word, pos, wp)
        wp = _merge_erhua(word, pos, wp)
        for ch, py in zip(word, wp):
            if py:
                kept.append(ch)
                sylls.append(py)
    return kept, sylls


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def replace_punctuation(text: str) -> str:
    """Reference chinese2.replace_punctuation: phonetic stand-ins for 嗯/呣,
    punctuation to the ascii inventory, strip everything else."""
    text = text.replace("嗯", "恩").replace("呣", "母")
    pattern = re.compile("|".join(re.escape(p) for p in _PUNC_MAP))
    text = pattern.sub(lambda m: _PUNC_MAP[m.group()], text)
    return re.sub(r"[^一-龥" + re.escape("".join(sorted(PUNCT))) + r"]+", "", text)


def _collapse_punct(text: str) -> str:
    p = "".join(re.escape(c) for c in PUNCT)
    return re.sub(f"([{p}])([{p}])+", r"\1", text)


def normalize(text: str) -> str:
    """TN + punctuation mapping, the reference's chinese2.text_normalize."""
    from gpt_sovits_tpu_torch.text.zh_norm import normalize_sentences

    out = "".join(replace_punctuation(s) for s in normalize_sentences(text))
    return _collapse_punct(out)


def clean_text_zh(text: str) -> tuple[list[str], list[int], str]:
    norm = normalize(text)
    pattern = "(?<=[{0}])\\s*".format("".join(sorted(PUNCT)))
    segments = [s for s in re.split(pattern, norm) if s.strip()]
    chars: list[str] = []
    sylls: list[str] = []
    for seg in segments:
        c, s = _g2p_segment(seg)
        chars.extend(c)
        sylls.extend(s)
    phones, word2ph = pinyin_to_phones(sylls)
    return phones, word2ph, "".join(chars)
