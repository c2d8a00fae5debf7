"""Japanese g2p: kana/kanji -> phoneme sequence.

A copy of gpt_sovits_tpu/text/japanese.py with its data files.

Counterpart of text/japanese.py, which uses pyopenjtalk (full-lexicon MeCab
analysis). When that package is importable it is used; otherwise the
built-in path covers kana (hiragana/katakana) exactly — the phone inventory
matches the v2 symbol table's romaji units (a/i/u/e/o consonant units, N
for ん, cl for っ) — and kanji through the bundled reading lexicon
(data/ja_kanji.json.gz, generated by scripts/gen_ja_data.py):
longest-match word segmentation (captures rendaku/sokuon compounds and
jukujikun), per-character fallback readings, sino-Japanese number reading
with counter sound changes (一本 いっぽん, 三分 さんぷん).
"""

from __future__ import annotations

import functools
import gzip
import json
import os
import re

PUNCT = set(",.!?-…")

# base kana -> phones (v2 symbol units)
_KANA = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "k a", "き": "k i", "く": "k u", "け": "k e", "こ": "k o",
    "が": "g a", "ぎ": "g i", "ぐ": "g u", "げ": "g e", "ご": "g o",
    "さ": "s a", "し": "sh i", "す": "s u", "せ": "s e", "そ": "s o",
    "ざ": "z a", "じ": "j i", "ず": "z u", "ぜ": "z e", "ぞ": "z o",
    "た": "t a", "ち": "ch i", "つ": "ts u", "て": "t e", "と": "t o",
    "だ": "d a", "ぢ": "j i", "づ": "z u", "で": "d e", "ど": "d o",
    "な": "n a", "に": "n i", "ぬ": "n u", "ね": "n e", "の": "n o",
    "は": "h a", "ひ": "h i", "ふ": "f u", "へ": "h e", "ほ": "h o",
    "ば": "b a", "び": "b i", "ぶ": "b u", "べ": "b e", "ぼ": "b o",
    "ぱ": "p a", "ぴ": "p i", "ぷ": "p u", "ぺ": "p e", "ぽ": "p o",
    "ま": "m a", "み": "m i", "む": "m u", "め": "m e", "も": "m o",
    "や": "y a", "ゆ": "y u", "よ": "y o",
    "ら": "r a", "り": "r i", "る": "r u", "れ": "r e", "ろ": "r o",
    "わ": "w a", "を": "o", "ん": "N", "っ": "cl", "ー": "-",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゔ": "v u",
}

# palatalized digraphs (きゃ etc.)
_DIGRAPH = {
    "きゃ": "ky a", "きゅ": "ky u", "きょ": "ky o",
    "ぎゃ": "gy a", "ぎゅ": "gy u", "ぎょ": "gy o",
    "しゃ": "sh a", "しゅ": "sh u", "しょ": "sh o",
    "じゃ": "j a", "じゅ": "j u", "じょ": "j o",
    "ちゃ": "ch a", "ちゅ": "ch u", "ちょ": "ch o",
    "にゃ": "ny a", "にゅ": "ny u", "にょ": "ny o",
    "ひゃ": "hy a", "ひゅ": "hy u", "ひょ": "hy o",
    "びゃ": "by a", "びゅ": "by u", "びょ": "by o",
    "ぴゃ": "py a", "ぴゅ": "py u", "ぴょ": "py o",
    "みゃ": "my a", "みゅ": "my u", "みょ": "my o",
    "りゃ": "ry a", "りゅ": "ry u", "りょ": "ry o",
    "ふぁ": "f a", "ふぃ": "f i", "ふぇ": "f e", "ふぉ": "f o",
    "てぃ": "t i", "でぃ": "d i", "うぃ": "w i", "うぇ": "w e",
}

_PUNC_MAP = {"、": ",", "。": ".", "！": "!", "？": "?", "・": ",", "「": "", "」": "", "『": "", "』": ""}


def _kata_to_hira(text: str) -> str:
    return "".join(chr(ord(c) - 0x60) if "ァ" <= c <= "ヶ" else c for c in text)


def _has_kanji(text: str) -> bool:
    return any(0x4E00 <= ord(c) <= 0x9FFF for c in text)


def kana_to_phones(text: str) -> list[str]:
    text = _kata_to_hira(text)
    phones: list[str] = []
    i = 0
    while i < len(text):
        pair = text[i : i + 2]
        ch = text[i]
        if pair in _DIGRAPH:
            phones.extend(_DIGRAPH[pair].split())
            i += 2
            continue
        if ch in _KANA:
            p = _KANA[ch]
            if p == "-":  # long vowel: repeat previous vowel
                if phones and phones[-1] in "aiueo":
                    phones.append(phones[-1])
            else:
                phones.extend(p.split())
            i += 1
            continue
        if ch in _PUNC_MAP:
            m = _PUNC_MAP[ch]
            if m:
                phones.append(m)
            i += 1
            continue
        if ch in PUNCT:
            phones.append(ch)
            i += 1
            continue
        i += 1  # drop unknown (space etc.)
    return phones


@functools.lru_cache(maxsize=1)
def _lexicon() -> dict:
    path = os.path.join(os.path.dirname(__file__), "data", "ja_kanji.json.gz")
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# sino-Japanese number reading (digits -> kana) with counter sound changes
# ---------------------------------------------------------------------------
_DIGIT = ["れい", "いち", "に", "さん", "よん", "ご", "ろく", "なな", "はち", "きゅう"]
_KANJI_NUM = {c: i for i, c in enumerate("〇一二三四五六七八九")}
_KANJI_UNIT = {"十": 10, "百": 100, "千": 1000, "万": 10**4, "億": 10**8, "兆": 10**12}


def number_to_kana(n: int) -> str:
    """0..10^16-1 -> sino-Japanese hiragana (さんびゃく, ろっぴゃく, …)."""
    if n == 0:
        return "ゼロ"
    parts: list[str] = []
    for unit_val, unit_kana in ((10**12, "ちょう"), (10**8, "おく"), (10**4, "まん")):
        if n >= unit_val:
            head = n // unit_val
            n %= unit_val
            h = number_to_kana(head)
            if unit_kana == "ちょう" and (head % 10 in (1, 8) or head % 100 == 10):
                h = h[:-1] + "っ"  # いっちょう / はっちょう / じゅっちょう
            parts.append(h + unit_kana)
    for unit_val, unit_kana in ((1000, "せん"), (100, "ひゃく"), (10, "じゅう")):
        if n >= unit_val:
            head = n // unit_val
            n %= unit_val
            if head == 1:
                parts.append(unit_kana)
            elif head == 3:
                parts.append("さん" + {"せん": "ぜん", "ひゃく": "びゃく", "じゅう": "じゅう"}[unit_kana])
            elif head == 6 and unit_kana == "ひゃく":
                parts.append("ろっぴゃく")
            elif head == 8 and unit_kana == "ひゃく":
                parts.append("はっぴゃく")
            elif head == 8 and unit_kana == "せん":
                parts.append("はっせん")
            else:
                parts.append(_DIGIT[head] + unit_kana)
    if n:
        parts.append(_DIGIT[n])
    return "".join(parts)


# counter -> (kana, irregular forms by trailing number). Default join is
# number_to_kana(n) + kana; the gemination/voicing table covers the common
# sound-change families (h->p with っ, さん+h->b, …).
_COUNTERS: dict[str, tuple[str, dict[int, str]]] = {
    "本": ("ほん", {1: "いっぽん", 3: "さんぼん", 6: "ろっぽん", 8: "はっぽん", 10: "じゅっぽん"}),
    "分": ("ふん", {1: "いっぷん", 3: "さんぷん", 4: "よんぷん", 6: "ろっぷん", 8: "はっぷん", 10: "じゅっぷん"}),
    "匹": ("ひき", {1: "いっぴき", 3: "さんびき", 6: "ろっぴき", 8: "はっぴき", 10: "じゅっぴき"}),
    "杯": ("はい", {1: "いっぱい", 3: "さんばい", 6: "ろっぱい", 8: "はっぱい", 10: "じゅっぱい"}),
    "回": ("かい", {1: "いっかい", 6: "ろっかい", 8: "はっかい", 10: "じゅっかい"}),
    "階": ("かい", {1: "いっかい", 3: "さんがい", 6: "ろっかい", 8: "はっかい", 10: "じゅっかい"}),
    "個": ("こ", {1: "いっこ", 6: "ろっこ", 8: "はっこ", 10: "じゅっこ"}),
    "歳": ("さい", {1: "いっさい", 8: "はっさい", 10: "じゅっさい", 20: "はたち"}),
    "冊": ("さつ", {1: "いっさつ", 8: "はっさつ", 10: "じゅっさつ"}),
    "軒": ("けん", {1: "いっけん", 6: "ろっけん", 8: "はっけん", 10: "じゅっけん"}),
    "円": ("えん", {4: "よえん"}),
    "人": ("にん", {1: "ひとり", 2: "ふたり", 4: "よにん"}),
    "時": ("じ", {4: "よじ", 7: "しちじ", 9: "くじ"}),
    "日": ("にち", {1: "ついたち", 2: "ふつか", 3: "みっか", 4: "よっか", 5: "いつか",
                    6: "むいか", 7: "なのか", 8: "ようか", 9: "ここのか", 10: "とおか",
                    14: "じゅうよっか", 20: "はつか", 24: "にじゅうよっか"}),
    "月": ("がつ", {4: "しがつ", 7: "しちがつ", 9: "くがつ"}),
    "年": ("ねん", {4: "よねん"}),
    "枚": ("まい", {}),
    "台": ("だい", {}),
    "番": ("ばん", {}),
    "度": ("ど", {}),
    "点": ("てん", {1: "いってん", 8: "はってん", 10: "じゅってん"}),
    "倍": ("ばい", {}),
    "秒": ("びょう", {}),
    "頭": ("とう", {1: "いっとう", 8: "はっとう", 10: "じゅっとう"}),
    "週": ("しゅう", {1: "いっしゅう", 8: "はっしゅう", 10: "じゅっしゅう"}),
    "時間": ("じかん", {4: "よじかん", 9: "くじかん"}),
    "週間": ("しゅうかん", {1: "いっしゅうかん", 8: "はっしゅうかん", 10: "じゅっしゅうかん"}),
    "か月": ("かげつ", {1: "いっかげつ", 6: "ろっかげつ", 8: "はっかげつ", 10: "じゅっかげつ"}),
    "年間": ("ねんかん", {4: "よねんかん"}),
}
_COUNTER_ALIASES = {"ヶ月": "か月", "ヵ月": "か月", "カ月": "か月", "箇月": "か月", "ケ月": "か月"}


def _counter_at(text: str, i: int) -> str | None:
    """Longest counter (canonicalized) starting at text[i], else None."""
    for ln in (2, 1):
        c = text[i : i + ln]
        c = _COUNTER_ALIASES.get(c, c)
        if c in _COUNTERS:
            return text[i : i + ln]
    return None


# (counter, tail) pairs whose irregular form is a whole-word replacement and
# must NOT compose with a tens head (11人 is じゅういちにん, not じゅうひとり)
_NO_TAIL_COMPOSE = {"人": {1, 2}, "日": set(range(1, 11)) | {20}, "歳": {20}, "月": set(range(1, 13))}


def _read_counted(n: int, counter: str) -> str:
    kana, irregular = _COUNTERS[counter]
    if n in irregular:
        return irregular[n]
    blocked = _NO_TAIL_COMPOSE.get(counter, set())
    for tail in (n % 100, n % 10):
        if tail and tail != n and tail in irregular and tail not in blocked:
            return number_to_kana(n - tail) + irregular[tail]
    full = number_to_kana(n)
    # round tens geminate before geminating counters: 30分 さんじゅっぷん
    if full.endswith("じゅう") and 10 in irregular and 10 not in blocked:
        return full[: -len("じゅう")] + irregular[10]
    return full + kana


_NUM_RE = re.compile(r"[0-9０-９]+")
_KANJI_NUM_RE = re.compile(r"[〇一二三四五六七八九十百千万億兆]+")


def _kanji_num_value(s: str) -> int | None:
    """Kanji numeral run -> integer value (positional 二〇二四 or unit 千二百)."""
    if all(c in _KANJI_NUM for c in s):
        return int("".join(str(_KANJI_NUM[c]) for c in s))
    total = section = digit = 0
    for c in s:
        if c in _KANJI_NUM:
            digit = _KANJI_NUM[c]
        elif c in ("十", "百", "千"):
            section += (digit or 1) * _KANJI_UNIT[c]
            digit = 0
        elif c in ("万", "億", "兆"):
            # close out only the current section: 一億二千万 = 1·10^8 + 2000·10^4
            # (multiplying the running total would scale already-closed
            # higher units by the new one)
            total += (section + digit or 1) * _KANJI_UNIT[c]
            section = digit = 0
        else:
            return None
    return total + section + digit


_FW_DIGITS = str.maketrans("０１２３４５６７８９", "0123456789")


def _normalize_numbers(text: str) -> str:
    """Arabic digits (+ following counter kanji) -> kana readings."""
    out: list[str] = []
    i = 0
    while i < len(text):
        m = _NUM_RE.match(text, i)
        if not m:
            out.append(text[i])
            i += 1
            continue
        num = int(m.group(0).translate(_FW_DIGITS))
        i = m.end()
        counter = _counter_at(text, i)
        if counter is not None:
            out.append(_read_counted(num, _COUNTER_ALIASES.get(counter, counter)))
            i += len(counter)
            if i < len(text) and text[i] == "後":  # duration suffix: 2週間後 ご
                out.append("ご")
                i += 1
        else:
            out.append(number_to_kana(num))
    return "".join(out)


def _kanji_to_kana(text: str) -> str:
    """Mixed kanji/kana -> kana via longest-match over the bundled lexicon."""
    lex = _lexicon()
    words, chars = lex["words"], lex["chars"]
    max_len = max(map(len, words))
    out: list[str] = []
    i = 0
    n = len(text)

    def particle_fix() -> int:
        # a kanji word match is a word boundary: a following は/へ is the
        # topic/direction particle, pronounced わ/え (pyopenjtalk parity)
        nonlocal i
        if i < n and text[i] == "は":
            out.append("わ")
            i += 1
        elif i < n and text[i] == "へ":
            out.append("え")
            i += 1
        return i

    while i < n:
        # kanji-numeral runs read as numbers (二十三 -> にじゅうさん); a
        # single numeral takes this path only before a counter (一本)
        m = _KANJI_NUM_RE.match(text, i)
        if m and m.group(0) not in words and (
            m.end() - m.start() >= 2 or _counter_at(text, m.end()) is not None
        ):
            val = _kanji_num_value(m.group(0))
            if val is not None:
                counter = _counter_at(text, m.end())
                if counter is not None:
                    out.append(_read_counted(val, _COUNTER_ALIASES.get(counter, counter)))
                    i = m.end() + len(counter)
                else:
                    out.append(number_to_kana(val))
                    i = m.end()
                if i < n and text[i] == "後":  # duration suffix: 二日後 ふつかご
                    out.append("ご")
                    i += 1
                particle_fix()
                continue
        for ln in range(min(max_len, n - i), 1, -1):
            w = text[i : i + ln]
            if w in words:
                out.append(words[w])
                i += ln
                particle_fix()
                break
        else:
            ch = text[i]
            if ch == "々" and i > 0:
                ch = text[i - 1]  # iteration mark repeats the previous kanji
            if ch in words:
                out.append(words[ch])
                i += 1
                particle_fix()
            elif ch in chars:
                out.append(chars[ch])
                i += 1
                particle_fix()
            elif _has_kanji(ch):
                i += 1  # unknown kanji: drop (degrade quietly like UNK phones)
            else:
                out.append(text[i])
                i += 1
    return "".join(out)


def clean_text_ja(text: str) -> tuple[list[str], str]:
    try:
        import pyopenjtalk  # full-lexicon path when available

        norm = text
        phones = pyopenjtalk.g2p(norm).split(" ")
        phones = [p.replace("pau", ",") for p in phones]
        return phones, norm
    except ImportError:
        pass
    norm = _normalize_numbers(text)
    norm = norm.replace("こんにちは", "こんにちわ").replace("こんばんは", "こんばんわ")
    if _has_kanji(norm):
        norm = _kanji_to_kana(norm)
    return kana_to_phones(norm), norm
