"""Korean g2p: hangul -> compatibility-jamo phones.

A copy of gpt_sovits_tpu/text/korean.py.

Counterpart of text/korean.py (g2pk2 + jamo). Hangul decomposition is pure
unicode arithmetic; the v2 symbol table holds compatibility jamo (ㄱㄴㄷ…).
The main g2pk2 phonological rule families are built in — palatalization
(구개음화), ㅎ aspiration/deletion (격음화/ㅎ탈락), liaison incl. coda
clusters (연음), cluster simplification, coda neutralization (평파열음화),
nasalization (비음화), lateralization (유음화), tensification (경음화) —
applied in that order by `apply_pronunciation_rules`; the full g2pk2
package takes over when importable (it adds dictionary-dependent cases).
"""

from __future__ import annotations

PUNCT = set(",.!?-…")

_CHO = ["ㄱ", "ㄲ", "ㄴ", "ㄷ", "ㄸ", "ㄹ", "ㅁ", "ㅂ", "ㅃ", "ㅅ", "ㅆ", "ㅇ", "ㅈ", "ㅉ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]
_JUNG = ["ㅏ", "ㅐ", "ㅑ", "ㅒ", "ㅓ", "ㅔ", "ㅕ", "ㅖ", "ㅗ", "ㅘ", "ㅙ", "ㅚ", "ㅛ", "ㅜ", "ㅝ", "ㅞ", "ㅟ", "ㅠ", "ㅡ", "ㅢ", "ㅣ"]
_JONG = ["", "ㄱ", "ㄲ", "ㄳ", "ㄴ", "ㄵ", "ㄶ", "ㄷ", "ㄹ", "ㄺ", "ㄻ", "ㄼ", "ㄽ", "ㄾ", "ㄿ", "ㅀ", "ㅁ", "ㅂ", "ㅄ", "ㅅ", "ㅆ", "ㅇ", "ㅈ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]

_PUNC_MAP = {"，": ",", "。": ".", "！": "!", "？": "?", "、": ","}


def decompose(ch: str) -> tuple[str, str, str] | None:
    o = ord(ch)
    if not (0xAC00 <= o <= 0xD7A3):
        return None
    idx = o - 0xAC00
    cho = _CHO[idx // 588]
    jung = _JUNG[(idx % 588) // 28]
    jong = _JONG[idx % 28]
    return cho, jung, jong


def compose(cho: str, jung: str, jong: str = "") -> str:
    return chr(0xAC00 + _CHO.index(cho) * 588 + _JUNG.index(jung) * 28 + _JONG.index(jong))


# coda clusters (겹받침): liaison split (first stays, second moves onto the
# vowel: 읽어 -> 일거) vs the representative coda elsewhere (읽다 -> 익따)
_CLUSTER = {
    "ㄳ": ("ㄱ", "ㅅ"), "ㄵ": ("ㄴ", "ㅈ"), "ㄶ": ("ㄴ", "ㅎ"), "ㄺ": ("ㄹ", "ㄱ"),
    "ㄻ": ("ㄹ", "ㅁ"), "ㄼ": ("ㄹ", "ㅂ"), "ㄽ": ("ㄹ", "ㅅ"), "ㄾ": ("ㄹ", "ㅌ"),
    "ㄿ": ("ㄹ", "ㅍ"), "ㅀ": ("ㄹ", "ㅎ"), "ㅄ": ("ㅂ", "ㅅ"),
}
_CLUSTER_CODA = {
    "ㄳ": "ㄱ", "ㄵ": "ㄴ", "ㄶ": "ㄴ", "ㄺ": "ㄱ", "ㄻ": "ㅁ", "ㄼ": "ㄹ",
    "ㄽ": "ㄹ", "ㄾ": "ㄹ", "ㄿ": "ㅂ", "ㅀ": "ㄹ", "ㅄ": "ㅂ",
}
# coda neutralization to the 7 representative sounds (평파열음화)
_NEUTRAL = {
    "ㄲ": "ㄱ", "ㅋ": "ㄱ", "ㅅ": "ㄷ", "ㅆ": "ㄷ", "ㅈ": "ㄷ", "ㅊ": "ㄷ",
    "ㅌ": "ㄷ", "ㅎ": "ㄷ", "ㅍ": "ㅂ",
}
_ASPIRATE = {"ㄱ": "ㅋ", "ㄷ": "ㅌ", "ㅈ": "ㅊ", "ㅂ": "ㅍ"}
_TENSE = {"ㄱ": "ㄲ", "ㄷ": "ㄸ", "ㅂ": "ㅃ", "ㅅ": "ㅆ", "ㅈ": "ㅉ"}
_NASAL = {"ㄱ": "ㅇ", "ㄷ": "ㄴ", "ㅂ": "ㅁ"}


def apply_pronunciation_rules(sylls: list) -> list:
    """g2pk2's main phonological rules over decomposed syllables
    ((cho, jung, jong) tuples; non-hangul items pass through)."""
    s = [list(x) if isinstance(x, tuple) else x for x in sylls]

    def pairs():
        for i in range(len(s) - 1):
            if isinstance(s[i], list) and isinstance(s[i + 1], list):
                yield i

    # 구개음화: ㄷ/ㅌ (incl. ㄾ) + 이 -> 지/치
    for i in pairs():
        a, b = s[i], s[i + 1]
        if b[0] == "ㅇ" and b[1] == "ㅣ":
            if a[2] == "ㄷ":
                a[2], b[0] = "", "ㅈ"
            elif a[2] == "ㅌ":
                a[2], b[0] = "", "ㅊ"
            elif a[2] == "ㄾ":
                a[2], b[0] = "ㄹ", "ㅊ"
    # ㅎ rules: coda ㅎ/ㄶ/ㅀ + lax onset -> aspirate; + vowel -> ㅎ deletion;
    # coda obstruent + onset ㅎ -> aspirated onset
    for i in pairs():
        a, b = s[i], s[i + 1]
        if a[2] in ("ㅎ", "ㄶ", "ㅀ"):
            keep = {"ㅎ": "", "ㄶ": "ㄴ", "ㅀ": "ㄹ"}[a[2]]
            if b[0] in _ASPIRATE:
                a[2], b[0] = keep, _ASPIRATE[b[0]]
            elif b[0] == "ㅅ":
                a[2], b[0] = keep, "ㅆ"
            elif b[0] == "ㅇ":
                a[2] = keep  # 좋아 -> 조아, 많아 -> 마나 (liaison below)
        elif b[0] == "ㅎ" and a[2] in _ASPIRATE:
            a[2], b[0] = "", _ASPIRATE[a[2]]
    # 연음 (liaison) before a vowel onset, clusters split (읽어 -> 일거)
    for i in pairs():
        a, b = s[i], s[i + 1]
        if a[2] and b[0] == "ㅇ":
            if a[2] in _CLUSTER:
                keep, move = _CLUSTER[a[2]]
                if move != "ㅎ":
                    a[2], b[0] = keep, move
            elif a[2] != "ㅇ":
                move = a[2]
                a[2], b[0] = "", ("ㅆ" if move == "ㅆ" else move)
    # remaining coda clusters simplify, then neutralize to the 7 codas
    for x in s:
        if isinstance(x, list):
            if x[2] in _CLUSTER_CODA:
                x[2] = _CLUSTER_CODA[x[2]]
            x[2] = _NEUTRAL.get(x[2], x[2])
    # 경음화 first records the pre-nasalization coda class
    tense_after = [
        isinstance(x, list) and x[2] in ("ㄱ", "ㄷ", "ㅂ") for x in s
    ]
    # 비음화: obstruent coda + nasal onset; ㄹ-onset nasalizes after non-ㄹ coda
    for i in pairs():
        a, b = s[i], s[i + 1]
        if b[0] in ("ㄴ", "ㅁ") and a[2] in _NASAL:
            a[2] = _NASAL[a[2]]
        elif b[0] == "ㄹ":
            if a[2] in ("ㅁ", "ㅇ"):
                b[0] = "ㄴ"
            elif a[2] in _NASAL:  # 협력 -> 혐녁
                a[2], b[0] = _NASAL[a[2]], "ㄴ"
    # 유음화: ㄴ+ㄹ / ㄹ+ㄴ -> ㄹㄹ
    for i in pairs():
        a, b = s[i], s[i + 1]
        if a[2] == "ㄴ" and b[0] == "ㄹ":
            a[2] = "ㄹ"
        elif a[2] == "ㄹ" and b[0] == "ㄴ":
            b[0] = "ㄹ"
    # 경음화: obstruent coda (pre-nasalization) + lax onset -> tense
    for i in pairs():
        b = s[i + 1]
        if tense_after[i] and b[0] in _TENSE:
            b[0] = _TENSE[b[0]]
    return [tuple(x) if isinstance(x, list) else x for x in s]


def hangul_to_jamo_phones(text: str) -> list[str]:
    """Decompose and apply the pronunciation rules, then flatten to
    compatibility-jamo phones."""
    sylls = [decompose(c) if decompose(c) else c for c in text]
    out_sylls = apply_pronunciation_rules(sylls)
    phones: list[str] = []
    for s in out_sylls:
        if isinstance(s, tuple):
            cho, jung, jong = s
            if cho != "ㅇ":
                phones.append(cho)
            phones.append(jung)
            if jong:
                phones.append(jong)
        elif s in _PUNC_MAP:
            phones.append(_PUNC_MAP[s])
        elif s in PUNCT:
            phones.append(s)
        # drop spaces/latin
    return phones


def pronounce(text: str) -> str:
    """Recomposed surface pronunciation (for tests / debugging):
    국물 -> 궁물, 신라 -> 실라."""
    out = []
    for s in apply_pronunciation_rules([decompose(c) if decompose(c) else c for c in text]):
        out.append(compose(*s) if isinstance(s, tuple) else s)
    return "".join(out)


def clean_text_ko(text: str) -> tuple[list[str], str]:
    try:
        from g2pk2 import G2p

        text = G2p()(text)
    except ImportError:
        pass
    return hangul_to_jamo_phones(text), text
