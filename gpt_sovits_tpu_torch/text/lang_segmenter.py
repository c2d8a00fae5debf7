"""Mixed-language segmentation.

A copy of gpt_sovits_tpu/text/lang_segmenter.py with its data files.

Counterpart of reference text/LangSegmenter/langsegmenter.py:77-213
(fast_langdetect + split-lang + rule post-processing). The ML detector
isn't available here, so the first stage (`base_split`) is a
unicode-range run splitter with a kana-context pass standing in for the
model (a sentence containing kana has its han runs re-tagged "ja",
mirroring how the reference's detector labels mixed kanji+kana text).
The second stage (`getTexts`) replicates the reference's post-processing
exactly: full-English promotion, `default_lang` coercion (used by the
``all_*`` modes to peel latin out while forcing everything else to the
declared language), digit-run neighbor resolution
(langsegmenter.py:168-196), and unknown-language filtering (:199-211).

The split stage is injectable (`_split=`) so parity tests can drive the
reference's live getTexts and this one from the same deterministic
splitter and assert equal output.
"""

from __future__ import annotations

import re

# same char set as the reference full_en (langsegmenter.py:18): latin +
# ascii printable + general/CJK-symbol punctuation + fullwidth forms
_FULL_EN_RE = re.compile(
    r"^(?=.*[A-Za-z])[A-Za-z0-9\s\u0020-\u007E\u2000-\u206F\u3000-\u303F\uFF00-\uFFEF]+$"
)

# per-char tail pattern used by the reference's full_cjk (langsegmenter.py:37)
_CJK_KEEP_RE = re.compile(r"[0-9、-〜。！？.!?… /]+$")

_CJK_RANGES = (
    (0x4E00, 0x9FFF),
    (0x3400, 0x4DB5),
    (0x20000, 0x2A6DD),
    (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F),
    (0x2B820, 0x2CEAF),
    (0x2CEB0, 0x2EBEF),
    (0x30000, 0x3134A),
    (0x31350, 0x323AF),
    (0x2EBF0, 0x2EE5D),
)

_SENT_END = set("。．.！!？?\n；;")


def full_en(text: str) -> bool:
    """Latin-with-ascii/fullwidth-punct run (langsegmenter.py:17-19)."""
    return bool(_FULL_EN_RE.match(text))


def full_cjk(text: str) -> str:
    """Keep only CJK ideographs + digit/punct chars (langsegmenter.py:22-45)."""
    out = []
    for ch in text:
        o = ord(ch)
        if any(a <= o <= b for a, b in _CJK_RANGES) or _CJK_KEEP_RE.match(ch):
            out.append(ch)
    return "".join(out)


def _char_class(ch: str) -> str | None:
    o = ord(ch)
    if ch.isdigit():
        return "digit"
    if any(a <= o <= b for a, b in _CJK_RANGES) or 0xF900 <= o <= 0xFAFF:
        return "zh"
    if 0x3040 <= o <= 0x30FF or 0x31F0 <= o <= 0x31FF:
        return "ja"
    if 0xAC00 <= o <= 0xD7AF or 0x1100 <= o <= 0x11FF or 0x3130 <= o <= 0x318F:
        return "ko"
    if (ch.isascii() and ch.isalpha()) or 0xFF21 <= o <= 0xFF5A:
        return "en"
    return None  # neutral: punctuation, space


_HAN_LANGID = None


def _langid_table():
    global _HAN_LANGID
    if _HAN_LANGID is None:
        import gzip
        import json
        import os

        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "han_langid.json.gz")
        with gzip.open(path, "rt") as f:
            t = json.load(f)
        _HAN_LANGID = {
            "ja_only": frozenset(t["ja_only"]),
            "ja_words": frozenset(t["ja_words"]),
            "zh_chars": frozenset(t["zh_chars"]),
        }
    return _HAN_LANGID


def _han_score(text: str) -> int:
    """zh-vs-ja score for a han-only run: >0 => Japanese. Stands in for
    the reference's fast_langdetect on kanji-only text
    (langsegmenter.py:11). Signals, derived from the bundled lexicons
    (scripts/build_langid_table.py): shinjitai/kokuji chars that never
    occur in Chinese (+3), ja-exclusive lexicon words (+2), chars only in
    the simplified-Chinese inventory (-1). Measured on lexicon-sampled
    sentences: ja recall 0.956 at zh precision 1.000."""
    t = _langid_table()
    score = 0
    for c in text:
        if c in t["ja_only"]:
            score += 3
        elif c in t["zh_chars"]:
            score -= 1
    i, n = 0, len(text)
    while i < n:
        for ln in (4, 3, 2):
            if text[i : i + ln] in t["ja_words"]:
                score += 2
                i += ln
                break
        else:
            i += 1
    return score


def base_split(text: str) -> list[dict]:
    """Unicode-range run splitter -> [{"lang": zh|ja|ko|en|digit, "text"}].

    Neutral chars (punctuation/space) attach to the preceding run; leading
    neutrals attach to the first run. Digits form their own runs
    (split-lang's ``merge_across_digit=False``). A final kana-context pass
    re-tags han runs as "ja" inside any sentence that also contains kana
    — the stand-in for model-based detection of Japanese prose, which is
    mostly kanji+kana interleave (reference relies on fast_langdetect for
    this, langsegmenter.py:11).
    """
    runs: list[dict] = []
    cur_lang: str | None = None
    cur: list[str] = []
    pending: list[str] = []

    def flush():
        nonlocal cur, cur_lang
        if cur_lang is not None and cur:
            runs.append({"lang": cur_lang, "text": "".join(cur)})
        cur = []
        cur_lang = None

    for ch in text:
        cls = _char_class(ch)
        if cls is None:
            (cur if cur_lang is not None else pending).append(ch)
            continue
        if cls != cur_lang:
            flush()
            cur = pending
            pending = []
            cur_lang = cls
        else:
            cur.extend(pending)
            pending = []
        cur.append(ch)
    flush()
    if pending:
        if runs:
            runs[-1]["text"] += "".join(pending)
        elif "".join(pending).strip():
            runs.append({"lang": "zh", "text": "".join(pending)})

    # kana-context pass: sentence-group, retag han -> ja where kana present.
    # Kana-free sentences additionally go through the bundled statistical
    # han classifier (shinjitai/kokuji char + ja-exclusive word evidence,
    # scripts/build_langid_table.py) so kanji-only Japanese — which the
    # reference catches with fast_langdetect (langsegmenter.py:11) — still
    # routes to the ja g2p in auto mode.
    out: list[dict] = []
    sent: list[dict] = []

    def _stat_split(r: dict) -> list[dict]:
        """Per-sentence statistical retag of one han run (a run can span
        several sentences when no other script interrupts it)."""
        pieces = re.split(r"(?<=[。．.！!？?\n；;])", r["text"])
        subs: list[dict] = []
        for pc in pieces:
            if not pc:
                continue
            lang = "ja" if _han_score(pc) > 0 else "zh"
            if subs and subs[-1]["lang"] == lang:
                subs[-1]["text"] += pc
            else:
                subs.append({"lang": lang, "text": pc})
        return subs or [r]

    def close_sentence():
        if any(r["lang"] == "ja" for r in sent):
            for r in sent:
                if r["lang"] == "zh":
                    r["lang"] = "ja"
            out.extend(sent)
        else:
            for r in sent:
                out.extend(_stat_split(r) if r["lang"] == "zh" else [r])
        sent.clear()

    for r in runs:
        sent.append(r)
        if r["text"] and r["text"][-1] in _SENT_END:
            close_sentence()
    close_sentence()
    return [r for r in out if r["text"].strip()]


def _merge(lang_list: list[dict], item: dict) -> list[dict]:
    """merge_lang (langsegmenter.py:69-74)."""
    if lang_list and item["lang"] == lang_list[-1]["lang"]:
        lang_list[-1]["text"] += item["text"]
    else:
        lang_list.append(item)
    return lang_list


_PUNCT_BOUNDARY = [",", ".", "!", "?", "，", "。", "！", "？"]


def getTexts(text: str, default_lang: str = "", _split=None) -> list[dict]:
    """Reference-equivalent LangSegmenter.getTexts (langsegmenter.py:90-213).

    With ``default_lang`` set, every run that isn't full-English is coerced
    to it (and digit runs too) — this is how the reference implements the
    ``all_zh``/``all_ja``/... modes' "peel latin, force the rest" behavior.
    Without it, detected languages are kept and digit runs are assigned by
    the neighbor rules of langsegmenter.py:168-196.
    """
    split = _split or base_split
    lang_list: list[dict] = []
    have_num = False
    for item in split(text):
        item = dict(item)
        if item["lang"] == "digit":
            if default_lang:
                item["lang"] = default_lang
            else:
                have_num = True
            _merge(lang_list, item)
            continue
        if full_en(item["text"]):
            item["lang"] = "en"
            _merge(lang_list, item)
            continue
        if default_lang:
            item["lang"] = default_lang
            _merge(lang_list, item)
            continue
        if item["lang"] == "x":
            cjk_text = full_cjk(item["text"])
            if cjk_text:
                item = {"lang": "zh", "text": cjk_text}
        _merge(lang_list, item)

    if have_num:
        temp_list = lang_list
        lang_list = []
        for i, temp_item in enumerate(temp_list):
            if temp_item["lang"] == "digit":
                # neighbor resolution (langsegmenter.py:172-194)
                if default_lang:
                    temp_item["lang"] = default_lang
                elif lang_list and i == len(temp_list) - 1:
                    temp_item["lang"] = lang_list[-1]["lang"]
                elif not lang_list and i < len(temp_list) - 1:
                    temp_item["lang"] = temp_list[1]["lang"]
                elif lang_list and i < len(temp_list) - 1:
                    if lang_list[-1]["lang"] == temp_list[i + 1]["lang"]:
                        temp_item["lang"] = lang_list[-1]["lang"]
                    elif lang_list[-1]["text"][-1] in _PUNCT_BOUNDARY:
                        temp_item["lang"] = temp_list[i + 1]["lang"]
                    elif temp_list[i + 1]["text"][0] in _PUNCT_BOUNDARY:
                        temp_item["lang"] = lang_list[-1]["lang"]
                    elif temp_item["text"][-1] in ["。", "."]:
                        temp_item["lang"] = lang_list[-1]["lang"]
                    elif len(lang_list[-1]["text"]) >= len(temp_list[i + 1]["text"]):
                        temp_item["lang"] = lang_list[-1]["lang"]
                    else:
                        temp_item["lang"] = temp_list[i + 1]["lang"]
                else:
                    temp_item["lang"] = "zh"
            lang_list = _merge(lang_list, temp_item)

    # unknown-language filter (langsegmenter.py:199-211)
    temp_list = lang_list
    lang_list = []
    for temp_item in temp_list:
        if temp_item["lang"] == "x":
            if lang_list:
                temp_item["lang"] = lang_list[-1]["lang"]
            elif len(temp_list) > 1:
                temp_item["lang"] = temp_list[1]["lang"]
            else:
                temp_item["lang"] = "zh"
        lang_list = _merge(lang_list, temp_item)
    return lang_list


def runs_for_language(text: str, language: str) -> list[dict]:
    """Per-mode run routing — reference get_phones_and_bert's dispatch
    (TTS_infer_pack/TextPreprocessor.py:122-170).

    - ``en``: whole text through English g2p.
    - ``all_zh``/``all_ja``/``all_ko``: segment with that default — embedded
      latin still peels out to "en", everything else is forced to the
      declared language. ``all_yue`` segments with default "zh" then maps
      zh->yue.
    - ``auto`` / ``auto_yue``: detected languages (zh->yue for auto_yue).
    - named CJK modes ``zh``/``ja``/``ko``/``yue`` (the common mixed modes,
      TextPreprocessor.py:158-169): en runs go to English g2p, every
      non-en run takes the user-declared language; adjacent runs of the
      same class merge.
    """
    if language == "en":
        return [{"lang": "en", "text": text}]
    if language == "all_zh":
        return getTexts(text, "zh")
    if language == "all_yue":
        runs = getTexts(text, "zh")
        for r in runs:
            if r["lang"] == "zh":
                r["lang"] = "yue"
        return runs
    if language == "all_ja":
        return getTexts(text, "ja")
    if language == "all_ko":
        return getTexts(text, "ko")
    if language in ("auto", "auto_yue"):
        runs = getTexts(text)
        if language == "auto_yue":
            for r in runs:
                if r["lang"] == "zh":
                    r["lang"] = "yue"
        return runs
    # named zh/ja/ko/yue: mixed-with-English semantics
    runs = []
    for tmp in getTexts(text):
        lang = "en" if tmp["lang"] == "en" else language
        if runs and (runs[-1]["lang"] == "en") == (lang == "en"):
            runs[-1]["text"] += tmp["text"]
        else:
            runs.append({"lang": lang, "text": tmp["text"]})
    return runs


def segment(text: str, default_lang: str = "zh") -> list[dict]:
    """Deprecated round-1 API: detected-language runs (auto mode)."""
    runs = getTexts(text)
    return runs if runs else ([{"lang": default_lang, "text": text}] if text.strip() else [])
