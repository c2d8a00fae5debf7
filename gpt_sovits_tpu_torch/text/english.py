"""English text normalization + grapheme-to-phoneme.

A copy of gpt_sovits_tpu/text/english.py with its data files.

Counterpart of reference text/english.py (`en_G2p`, english.py:248) and
text/en_normalization/expend.py. Ships (a) a bundled 135k-entry
CMU-derived lexicon (text/data/en_cmudict.json.gz, generated by
scripts/gen_en_data.py with the reference's get_dict() precedence —
hot-word overrides included), (b) a deterministic letter-to-sound rule
engine producing ARPAbet for OOV words, and (c) a drop-in hook for an
external CMU dict file (set GSV_CMUDICT_PATH) that overlays the bundle.

Output phones use the v2 symbol table's ARPAbet-with-stress convention.
"""

from __future__ import annotations

import functools
import os
import re

PUNCT = set(",.!?-…")

# -- normalization ----------------------------------------------------------

_ABBREV = {
    "mr": "mister", "mrs": "missus", "dr": "doctor", "st": "saint",
    "co": "company", "jr": "junior", "sr": "senior", "etc": "et cetera",
    "vs": "versus", "prof": "professor",
}

_ONES = "zero one two three four five six seven eight nine".split()
_TEENS = "ten eleven twelve thirteen fourteen fifteen sixteen seventeen eighteen nineteen".split()
_TENS = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()


def _num_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _num_to_words(-n)
    if n < 10:
        return _ONES[n]
    if n < 20:
        return _TEENS[n - 10]
    if n < 100:
        return _TENS[n // 10] + ("" if n % 10 == 0 else " " + _ONES[n % 10])
    if n < 1000:
        rest = n % 100
        return _ONES[n // 100] + " hundred" + ("" if rest == 0 else " " + _num_to_words(rest))
    for div, name in ((10**9, "billion"), (10**6, "million"), (10**3, "thousand")):
        if n >= div:
            rest = n % div
            return _num_to_words(n // div) + f" {name}" + ("" if rest == 0 else " " + _num_to_words(rest))
    return str(n)


def _expand_number(m: re.Match) -> str:
    s = m.group(0).replace(",", "")
    if "." in s:
        int_part, frac = s.split(".", 1)
        words = _num_to_words(int(int_part)) if int_part else "zero"
        return words + " point " + " ".join(_ONES[int(c)] for c in frac if c.isdigit())
    return _num_to_words(int(s))


_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _ordinalize(words: str) -> str:
    parts = words.split()
    last = parts[-1]
    if last in _ORDINAL_SPECIAL:
        parts[-1] = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        parts[-1] = last[:-1] + "ieth"
    else:
        parts[-1] = last + "th"
    return " ".join(parts)


def _money(amount: str, unit: str, sub_unit: str, sub_plural: str) -> str:
    """$6.24 -> 'six dollars and twenty four cents' (ref en_normalization/
    expend.py:117-166, sub-unit zero-padded to two digits)."""
    parts = amount.replace(",", "").split(".")
    if len(parts) > 2:
        return amount + f" {unit}s"
    main = int(parts[0]) if parts[0] else 0
    sub = int(parts[1].ljust(2, "0")[:2]) if len(parts) > 1 and parts[1] else 0
    bits = []
    if main:
        bits.append(_num_to_words(main) + " " + (unit if main == 1 else unit + "s"))
    if sub:
        bits.append(_num_to_words(sub) + " " + (sub_unit if sub == 1 else sub_plural))
    return " and ".join(bits) if bits else f"zero {unit}s"


_FRACTION_DENOM = {2: ("half", "halves")}


def _fraction(num: int, den: int) -> str:
    """1/3 -> one third, 3/4 -> three fourths, 3/2 -> three halves
    (expend.py:188-218)."""
    top = _num_to_words(num)
    if den == 1:
        return top
    if den == 2:
        return f"{top} " + ("half" if num == 1 else "halves")
    bottom = _ordinalize(_num_to_words(den))
    if num > 1:
        bottom += "s"
    return f"{top} {bottom}"


_MEASURES_EN = {
    "km/h": "kilometers per hour", "km": "kilometers", "m": "meters",
    "ft": "feet", "L": "liters", "tbsp": "tablespoons", "tsp": "teaspoons",
    "h": "hours", "min": "minutes", "s": "seconds",
    "°C": "degrees celsius", "°F": "degrees fahrenheit",
}


def _year_number(n: int) -> str:
    """Year-style pairs reading for 1000<n<3000 (expend.py:226-238):
    1997 -> nineteen ninety seven, 2005 -> two thousand five,
    1900 -> nineteen hundred."""
    if n == 2000:
        return "two thousand"
    if 2000 < n < 2010:
        return "two thousand " + _num_to_words(n % 100)
    if n % 100 == 0:
        return _num_to_words(n // 100) + " hundred"
    hi, lo = divmod(n, 100)
    lo_words = _num_to_words(lo) if lo >= 10 else "oh " + _num_to_words(lo)
    return _num_to_words(hi) + " " + lo_words


def normalize(text: str) -> str:
    text = text.replace("’", "'").replace("“", '"').replace("”", '"')
    # money with sub-units, leading or trailing currency sign (expend.py)
    for sign, units in (("£", ("pound", "penny", "pence")), ("\\$", ("dollar", "cent", "cents"))):
        text = re.sub(rf"{sign}(\d[\d,]*(\.\d+)?)", lambda m, u=units: _money(m.group(1), *u), text)
        text = re.sub(rf"(\d[\d,]*(\.\d+)?){sign}", lambda m, u=units: _money(m.group(1), *u), text)
    text = re.sub(r"(\d[\d,]*)(\.\d+)?%", lambda m: m.group(0)[:-1] + " percent", text)
    # measurement suffixes (expend.py:101-114)
    units_alt = "|".join(re.escape(u) for u in sorted(_MEASURES_EN, key=len, reverse=True))
    text = re.sub(
        rf"\b(\d+(?:\.\d+)?)({units_alt})\b",
        lambda m: m.group(1) + " " + _MEASURES_EN[m.group(2)],
        text,
    )
    text = re.sub(r"(\d+(?:\.\d+)?)(°C|°F)", lambda m: m.group(1) + " " + _MEASURES_EN[m.group(2)], text)
    # ordinals: 1st 2nd 3rd 21st ...
    text = re.sub(
        r"(\d+)(st|nd|rd|th)\b", lambda m: _ordinalize(_num_to_words(int(m.group(1)))), text
    )
    # clock time: 3:30 -> three thirty; 3:05 -> three oh five
    def _time(m):
        h, mi = int(m.group(1)), m.group(2)
        if mi == "00":
            return _num_to_words(h) + " o'clock"
        if mi.startswith("0"):
            return _num_to_words(h) + " oh " + _num_to_words(int(mi))
        return _num_to_words(h) + " " + _num_to_words(int(mi))

    text = re.sub(r"\b(\d{1,2}):(\d{2})\b", _time, text)
    # fractions: 3/4 -> three fourths (expend.py:188-218)
    text = re.sub(r"\b(\d+)/(\d+)\b", lambda m: _fraction(int(m.group(1)), int(m.group(2))), text)
    # minus sign on negative numbers
    text = re.sub(r"(?<![\w.])-(\d)", r"minus \1", text)
    # bare 4-digit years read in pairs (expend.py:226-238)
    text = re.sub(
        r"\b([12]\d{3})\b(?!\s*(?:point|\.\d))",
        lambda m: _year_number(int(m.group(1))) if 1000 < int(m.group(1)) < 3000 else m.group(0),
        text,
    )
    text = re.sub(r"\d[\d,]*(\.\d+)?", _expand_number, text)
    words = []
    for w in re.findall(r"[A-Za-z']+|[^\sA-Za-z']", text):
        lw = w.lower().rstrip(".")
        words.append(_ABBREV.get(lw, w))
    out = " ".join(words)
    out = re.sub(r"\s+([,.!?])", r"\1", out)
    return out


# -- lexicon ----------------------------------------------------------------

# Frequent words whose rule-based pronunciation would be wrong.
_LEXICON = {
    "the": "DH AH0", "of": "AH1 V", "to": "T UW1", "and": "AE1 N D",
    "a": "AH0", "in": "IH0 N", "is": "IH1 Z", "it": "IH1 T",
    "you": "Y UW1", "that": "DH AE1 T", "he": "HH IY1", "was": "W AA1 Z",
    "for": "F AO1 R", "on": "AA1 N", "are": "AA1 R", "with": "W IH1 DH",
    "as": "AE1 Z", "i": "AY1", "his": "HH IH1 Z", "they": "DH EY1",
    "be": "B IY1", "at": "AE1 T", "one": "W AH1 N", "have": "HH AE1 V",
    "this": "DH IH1 S", "from": "F R AH1 M", "or": "AO1 R", "had": "HH AE1 D",
    "by": "B AY1", "word": "W ER1 D", "but": "B AH1 T", "not": "N AA1 T",
    "what": "W AH1 T", "all": "AO1 L", "were": "W ER1", "we": "W IY1",
    "when": "W EH1 N", "your": "Y AO1 R", "can": "K AE1 N", "said": "S EH1 D",
    "there": "DH EH1 R", "use": "Y UW1 S", "an": "AE1 N", "each": "IY1 CH",
    "which": "W IH1 CH", "she": "SH IY1", "do": "D UW1", "how": "HH AW1",
    "their": "DH EH1 R", "if": "IH1 F", "will": "W IH1 L", "up": "AH1 P",
    "other": "AH1 DH ER0", "about": "AH0 B AW1 T", "out": "AW1 T",
    "many": "M EH1 N IY0", "then": "DH EH1 N", "them": "DH EH1 M",
    "these": "DH IY1 Z", "so": "S OW1", "some": "S AH1 M", "her": "HH ER1",
    "would": "W UH1 D", "make": "M EY1 K", "like": "L AY1 K",
    "him": "HH IH1 M", "into": "IH1 N T UW0", "time": "T AY1 M",
    "has": "HH AE1 Z", "look": "L UH1 K", "two": "T UW1", "more": "M AO1 R",
    "write": "R AY1 T", "go": "G OW1", "see": "S IY1", "no": "N OW1",
    "way": "W EY1", "could": "K UH1 D", "people": "P IY1 P AH0 L",
    "my": "M AY1", "than": "DH AE1 N", "first": "F ER1 S T",
    "water": "W AO1 T ER0", "been": "B IH1 N", "who": "HH UW1",
    "oil": "OY1 L", "its": "IH1 T S", "now": "N AW1", "find": "F AY1 N D",
    "long": "L AO1 NG", "down": "D AW1 N", "day": "D EY1", "did": "D IH1 D",
    "get": "G EH1 T", "come": "K AH1 M", "made": "M EY1 D", "may": "M EY1",
    "part": "P AA1 R T", "over": "OW1 V ER0", "new": "N UW1",
    "sound": "S AW1 N D", "take": "T EY1 K", "only": "OW1 N L IY0",
    "little": "L IH1 T AH0 L", "work": "W ER1 K", "know": "N OW1",
    "place": "P L EY1 S", "year": "Y IH1 R", "live": "L IH1 V",
    "me": "M IY1", "back": "B AE1 K", "give": "G IH1 V", "most": "M OW1 S T",
    "very": "V EH1 R IY0", "after": "AE1 F T ER0", "thing": "TH IH1 NG",
    "our": "AW1 ER0", "just": "JH AH1 S T", "name": "N EY1 M",
    "good": "G UH1 D", "sentence": "S EH1 N T AH0 N S", "man": "M AE1 N",
    "think": "TH IH1 NG K", "say": "S EY1", "great": "G R EY1 T",
    "where": "W EH1 R", "help": "HH EH1 L P", "through": "TH R UW1",
    "much": "M AH1 CH", "before": "B IH0 F AO1 R", "line": "L AY1 N",
    "right": "R AY1 T", "too": "T UW1", "mean": "M IY1 N", "old": "OW1 L D",
    "any": "EH1 N IY0", "same": "S EY1 M", "tell": "T EH1 L",
    "boy": "B OY1", "follow": "F AA1 L OW0", "came": "K EY1 M",
    "want": "W AA1 N T", "show": "SH OW1", "also": "AO1 L S OW0",
    "around": "ER0 AW1 N D", "form": "F AO1 R M", "three": "TH R IY1",
    "small": "S M AO1 L", "set": "S EH1 T", "put": "P UH1 T",
    "end": "EH1 N D", "does": "D AH1 Z", "another": "AH0 N AH1 DH ER0",
    "well": "W EH1 L", "large": "L AA1 R JH", "must": "M AH1 S T",
    "big": "B IH1 G", "even": "IY1 V AH0 N", "such": "S AH1 CH",
    "because": "B IH0 K AO1 Z", "turn": "T ER1 N", "here": "HH IY1 R",
    "why": "W AY1", "ask": "AE1 S K", "went": "W EH1 N T",
    "men": "M EH1 N", "read": "R IY1 D", "need": "N IY1 D",
    "land": "L AE1 N D", "different": "D IH1 F ER0 AH0 N T",
    "home": "HH OW1 M", "us": "AH1 S", "move": "M UW1 V",
    "try": "T R AY1", "kind": "K AY1 N D", "hand": "HH AE1 N D",
    "picture": "P IH1 K CH ER0", "again": "AH0 G EH1 N",
    "change": "CH EY1 N JH", "off": "AO1 F", "play": "P L EY1",
    "spell": "S P EH1 L", "air": "EH1 R", "away": "AH0 W EY1",
    "animal": "AE1 N AH0 M AH0 L", "house": "HH AW1 S",
    "point": "P OY1 N T", "page": "P EY1 JH", "letter": "L EH1 T ER0",
    "mother": "M AH1 DH ER0", "answer": "AE1 N S ER0",
    "found": "F AW1 N D", "study": "S T AH1 D IY0", "still": "S T IH1 L",
    "learn": "L ER1 N", "should": "SH UH1 D", "world": "W ER1 L D",
    "high": "HH AY1", "every": "EH1 V ER0 IY0", "near": "N IH1 R",
    "add": "AE1 D", "food": "F UW1 D", "between": "B IH0 T W IY1 N",
    "own": "OW1 N", "below": "B IH0 L OW1", "country": "K AH1 N T R IY0",
    "plant": "P L AE1 N T", "last": "L AE1 S T", "school": "S K UW1 L",
    "father": "F AA1 DH ER0", "keep": "K IY1 P", "tree": "T R IY1",
    "never": "N EH1 V ER0", "start": "S T AA1 R T", "city": "S IH1 T IY0",
    "earth": "ER1 TH", "eye": "AY1", "light": "L AY1 T",
    "thought": "TH AO1 T", "head": "HH EH1 D", "under": "AH1 N D ER0",
    "story": "S T AO1 R IY0", "saw": "S AO1", "left": "L EH1 F T",
    "don't": "D OW1 N T", "few": "F Y UW1", "while": "W AY1 L",
    "along": "AH0 L AO1 NG", "might": "M AY1 T", "close": "K L OW1 S",
    "something": "S AH1 M TH IH0 NG", "seem": "S IY1 M",
    "next": "N EH1 K S T", "hard": "HH AA1 R D", "open": "OW1 P AH0 N",
    "example": "IH0 G Z AE1 M P AH0 L", "begin": "B IH0 G IH1 N",
    "life": "L AY1 F", "always": "AO1 L W EY0 Z", "those": "DH OW1 Z",
    "both": "B OW1 TH", "paper": "P EY1 P ER0",
    "together": "T AH0 G EH1 DH ER0", "got": "G AA1 T",
    "group": "G R UW1 P", "often": "AO1 F AH0 N", "run": "R AH1 N",
    "important": "IH0 M P AO1 R T AH0 N T", "until": "AH0 N T IH1 L",
    "children": "CH IH1 L D R AH0 N", "side": "S AY1 D",
    "feet": "F IY1 T", "car": "K AA1 R", "mile": "M AY1 L",
    "night": "N AY1 T", "walk": "W AO1 K", "white": "W AY1 T",
    "sea": "S IY1", "began": "B IH0 G AE1 N", "grow": "G R OW1",
    "took": "T UH1 K", "river": "R IH1 V ER0", "four": "F AO1 R",
    "carry": "K AE1 R IY0", "state": "S T EY1 T", "once": "W AH1 N S",
    "book": "B UH1 K", "hear": "HH IY1 R", "stop": "S T AA1 P",
    "without": "W IH0 TH AW1 T", "second": "S EH1 K AH0 N D",
    "later": "L EY1 T ER0", "miss": "M IH1 S", "idea": "AY0 D IY1 AH0",
    "enough": "IH0 N AH1 F", "eat": "IY1 T", "face": "F EY1 S",
    "watch": "W AA1 CH", "far": "F AA1 R", "really": "R IH1 L IY0",
    "almost": "AO1 L M OW0 S T", "let": "L EH1 T", "above": "AH0 B AH1 V",
    "girl": "G ER1 L", "sometimes": "S AH1 M T AY0 M Z",
    "mountain": "M AW1 N T AH0 N", "cut": "K AH1 T", "young": "Y AH1 NG",
    "talk": "T AO1 K", "soon": "S UW1 N", "list": "L IH1 S T",
    "song": "S AO1 NG", "being": "B IY1 IH0 NG", "leave": "L IY1 V",
    "family": "F AE1 M AH0 L IY0", "hello": "HH AH0 L OW1",
    "voice": "V OY1 S", "speech": "S P IY1 CH", "model": "M AA1 D AH0 L",
    "test": "T EH1 S T", "text": "T EH1 K S T",
}

_DIGRAPHS = [
    ("tch", "CH"), ("sch", "S K"), ("ch", "CH"), ("sh", "SH"), ("th", "TH"),
    ("ph", "F"), ("wh", "W"), ("gh", "G"), ("ck", "K"), ("ng", "NG"),
    ("qu", "K W"), ("wr", "R"), ("kn", "N"), ("mb$", "M"),
]

_VOWEL_TEAMS = [
    ("eau", "OW"), ("igh", "AY"), ("eigh", "EY"), ("ough", "AO"),
    ("augh", "AO"), ("tion", "SH AH0 N"), ("sion", "ZH AH0 N"),
    ("ture", "CH ER0"), ("ous", "AH0 S"),
    ("ai", "EY"), ("ay", "EY"), ("ea", "IY"), ("ee", "IY"), ("ey", "IY"),
    ("oa", "OW"), ("oe", "OW"), ("oo", "UW"), ("ou", "AW"), ("ow", "AW"),
    ("oy", "OY"), ("oi", "OY"), ("au", "AO"), ("aw", "AO"), ("ie", "IY"),
    ("ue", "UW"), ("ui", "UW"), ("ar", "AA R"), ("er", "ER"), ("ir", "ER"),
    ("or", "AO R"), ("ur", "ER"),
]

_SHORT_VOWELS = {"a": "AE", "e": "EH", "i": "IH", "o": "AA", "u": "AH"}
_LONG_VOWELS = {"a": "EY", "e": "IY", "i": "AY", "o": "OW", "u": "UW"}
_CONS = {
    "b": "B", "c": "K", "d": "D", "f": "F", "g": "G", "h": "HH", "j": "JH",
    "k": "K", "l": "L", "m": "M", "n": "N", "p": "P", "r": "R", "s": "S",
    "t": "T", "v": "V", "w": "W", "x": "K S", "y": "Y", "z": "Z",
}


def _rules_g2p(word: str) -> list[str]:
    """Deterministic letter-to-sound rules -> ARPAbet (no stress)."""
    w = word.lower()
    phones: list[str] = []
    i = 0
    n = len(w)
    while i < n:
        matched = False
        for pat, ph in _VOWEL_TEAMS:
            if w.startswith(pat, i):
                phones.extend(ph.split())
                i += len(pat)
                matched = True
                break
        if matched:
            continue
        for pat, ph in _DIGRAPHS:
            p = pat.rstrip("$")
            if w.startswith(p, i) and (not pat.endswith("$") or i + len(p) == n):
                phones.extend(ph.split())
                i += len(p)
                matched = True
                break
        if matched:
            continue
        ch = w[i]
        if ch in "aeiou":
            # magic-e: vowel + cons + final e -> long vowel
            if i + 2 < n and w[i + 1] in _CONS and w[i + 2] == "e" and i + 3 == n:
                phones.append(_LONG_VOWELS[ch])
            elif i + 1 == n and ch == "e":
                if not phones or phones[-1] in _CONS.values():
                    pass  # silent final e
                else:
                    phones.append("IY")
            elif i + 1 == n and ch == "y":
                phones.append("IY")
            else:
                phones.append(_SHORT_VOWELS[ch])
            i += 1
            continue
        if ch == "y":
            phones.append("IY" if i + 1 == n else "Y")
            i += 1
            continue
        if ch == "c" and i + 1 < n and w[i + 1] in "eiy":
            phones.append("S")
            i += 1
            continue
        if ch == "g" and i + 1 < n and w[i + 1] in "eiy":
            phones.append("JH")
            i += 1
            continue
        if ch == "s" and i > 0 and i + 1 == n and phones and phones[-1] in (
            "B", "D", "G", "V", "DH", "Z", "ZH", "JH", "M", "N", "NG", "L", "R",
        ):
            phones.append("Z")
            i += 1
            continue
        if ch in _CONS:
            if i + 1 < n and w[i + 1] == ch:  # doubled consonant
                i += 1
            phones.extend(_CONS[ch].split())
            i += 1
            continue
        if ch == "'":
            i += 1
            continue
        i += 1
    # assign stress: primary on first vowel, 0 on the rest
    vowel_bases = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY", "OW", "OY", "UH", "UW"}
    out = []
    stressed = False
    for p in phones:
        if p in vowel_bases:
            out.append(p + ("1" if not stressed else "0"))
            stressed = True
        else:
            out.append(p)
    return out


@functools.lru_cache(maxsize=1)
def _cmu_dict() -> dict[str, list[str]]:
    """Built-in CMU-derived lexicon (data/en_cmudict.json.gz, 135k words —
    the reference's cmudict.rep + cmudict-fast + hot overrides merged by
    scripts/gen_en_data.py), optionally extended/overridden by a user dict
    at GSV_CMUDICT_PATH (standard cmudict line format)."""
    import gzip
    import json

    bundled = os.path.join(os.path.dirname(__file__), "data", "en_cmudict.json.gz")
    table: dict[str, list[str]] = {}
    if os.path.exists(bundled):
        with gzip.open(bundled, "rt", encoding="utf-8") as f:
            table = json.load(f)
    path = os.environ.get("GSV_CMUDICT_PATH")
    if path and os.path.exists(path):
        with open(path, errors="ignore") as f:
            for line in f:
                if line.startswith(";;;") or not line.strip():
                    continue
                parts = line.split()
                word = parts[0].lower()
                if "(" in word:
                    continue
                table[word] = parts[1:]
    return table


@functools.lru_cache(maxsize=1)
def _name_dict() -> dict[str, list[str]]:
    """First-name pronunciations (data/en_names.json.gz, ~20k), consulted
    for Title-case words only (reference en_G2p.qryword, english.py:315)."""
    import gzip
    import json

    bundled = os.path.join(os.path.dirname(__file__), "data", "en_names.json.gz")
    if os.path.exists(bundled):
        with gzip.open(bundled, "rt", encoding="utf-8") as f:
            return json.load(f)
    return {}


# 's voicing classes (reference english.py:336-346)
_VOICELESS = {"P", "T", "K", "F", "TH", "HH"}
_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}


def _possessive(phones: list[str]) -> list[str]:
    if phones[-1] in _VOICELESS:
        return phones + ["S"]
    if phones[-1] in _SIBILANT:
        return phones + ["AH0", "Z"]
    return phones + ["Z"]


def _split_compound(word: str) -> list[str] | None:
    """Greedy in-lexicon split for OOV compounds ('sunflowerseed' ->
    sunflower + seed): longest dictionary prefix first, parts >= 3 chars.
    Stands in for the reference's wordsegment dependency."""
    cmu = _cmu_dict()
    for i in range(len(word) - 3, 2, -1):
        head, tail = word[:i], word[i:]
        if head in cmu:
            if tail in cmu:
                return [head, tail]
            rest = _split_compound(tail)
            if rest:
                return [head] + rest
    return None


def g2p_word(word: str) -> list[str]:
    """One token -> ARPAbet phones, the reference qryword chain
    (english.py:248-357): dictionary, single letters, Title-case names,
    short-OOV letter spelling, possessives, compounds, then rules."""
    lw = word.lower()
    cmu = _cmu_dict()
    if len(lw) == 1:
        if word == "A":
            return ["EY1"]
        return list(cmu.get(lw) or g2p_word(_LETTER_NAMES.get(lw, lw)))
    if lw in cmu:
        return list(cmu[lw])
    if lw in _LEXICON:
        return _LEXICON[lw].split()
    if word.istitle() and lw in _name_dict():
        return list(_name_dict()[lw])
    if len(lw) <= 3 or word.isupper():
        # short OOV / acronym: letter-by-letter (A reads EY1)
        phones: list[str] = []
        for c in lw:
            if c == "a":
                phones.append("EY1")
            elif not c.isalpha():
                phones.append(c)
            else:
                phones.extend(g2p_word(c))
        return phones
    for suf in ("'s", "s'"):
        if lw.endswith(suf):
            return _possessive(g2p_word(lw[: -len(suf)]))
    comps = _split_compound(lw)
    if comps:
        return [p for c in comps for p in g2p_word(c)]
    return _rules_g2p(lw)


_LETTER_NAMES = {
    "a": "ay", "b": "bee", "c": "see", "d": "dee", "e": "ee", "f": "ef",
    "g": "jee", "h": "aitch", "i": "eye", "j": "jay", "k": "kay", "l": "el",
    "m": "em", "n": "en", "o": "oh", "p": "pee", "q": "cue", "r": "ar",
    "s": "ess", "t": "tee", "u": "you", "v": "vee", "w": "double you",
    "x": "ex", "y": "why", "z": "zee",
}


def g2p(text: str) -> list[str]:
    """Normalized text -> phone list (with punctuation preserved)."""
    phones: list[str] = []
    for token in re.findall(r"[A-Za-z']+|[,.!?…-]", text):
        if token in PUNCT:
            phones.append(token)
        else:
            phones.extend(g2p_word(token))
    return phones


def clean_text_en(text: str) -> tuple[list[str], str]:
    norm = normalize(text)
    return g2p(norm), norm
