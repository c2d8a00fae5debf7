"""Chinese text normalization (NSW verbalization), full rule set.

A copy of gpt_sovits_tpu/text/zh_norm.py with its data files.

Counterpart of the reference's text/zh_normalization/ package (PaddleSpeech
rules; text_normlization.py + num.py + chronology.py + phonecode.py +
quantifier.py + char_convert.py, ~900 LoC).  Output-equal by golden test
against the reference TextNormalizer (tests/test_zh_norm_golden.py) so the
zh frontend verbalizes dates, times, money, phone numbers, fractions,
ranges, measures, math and the long-tail number grammar identically.

Structure: one ordered pipeline of (pattern, verbalizer) passes per
sentence, mirroring the application order of the reference's
normalize_sentence (text_normlization.py:130-170), over a traditional->
simplified character map loaded from data/zh_t2s.json.gz.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import string
from functools import lru_cache

# ---------------------------------------------------------------------------
# number verbalization (reference num.py:277-339)
# ---------------------------------------------------------------------------

_DIGITS = "零一二三四五六七八九"
# unit name per power of ten; the grammar recurses on the largest unit whose
# power is strictly below the digit count (num.py:287)
_UNITS = {1: "十", 2: "百", 3: "千", 4: "万", 8: "亿"}
_UNIT_POWERS = sorted(_UNITS, reverse=True)


def _cardinal_parts(s: str, keep_zero: bool = True) -> list[str]:
    """Recursive place-value reading of a digit string (num.py _get_value)."""
    stripped = s.lstrip("0")
    if not stripped:
        return []
    if len(stripped) == 1:
        if keep_zero and len(stripped) < len(s):
            return ["零", _DIGITS[int(stripped)]]
        return [_DIGITS[int(stripped)]]
    power = next(p for p in _UNIT_POWERS if p < len(stripped))
    head, tail = s[:-power], s[-power:]
    return _cardinal_parts(head) + [_UNITS[power]] + _cardinal_parts(tail)


def verbalize_cardinal(s: str) -> str:
    """'10005' -> 一万零五; '110' -> 一百一十; leading 一十 abbreviates to 十."""
    if not s:
        return ""
    s = s.lstrip("0")
    if not s:
        return "零"
    parts = _cardinal_parts(s)
    if len(parts) >= 2 and parts[0] == "一" and parts[1] == "十":
        parts = parts[1:]
    return "".join(parts)


def verbalize_digits(s: str, alt_one: bool = False) -> str:
    """Digit-by-digit reading; alt_one reads 1 as 幺 (phone numbers, ids)."""
    out = "".join(_DIGITS[int(c)] for c in s if c.isdigit())
    return out.replace("一", "幺") if alt_one else out


def num2str(value: str) -> str:
    """Cardinal + optional 点-separated decimal (reference num2str)."""
    if value.count(".") > 1:
        raise ValueError(f"more than one decimal point in {value!r}")
    integer, _, decimal = value.partition(".")
    result = verbalize_cardinal(integer)
    # trailing zeros collapse to a single one ('3.20' -> 三点二零)
    decimal = decimal.rstrip("0") + "0" if decimal.endswith("0") else decimal.rstrip("0")
    if decimal:
        result = (result or "零") + "点" + verbalize_digits(decimal)
    return result


# compatibility aliases for earlier rounds' imports
def num_to_hanzi(n: int) -> str:
    return ("负" if n < 0 else "") + verbalize_cardinal(str(abs(n)))


def digits_to_hanzi(s: str) -> str:
    return verbalize_digits(s)


def decimal_to_hanzi(s: str) -> str:
    return num2str(s)


# ---------------------------------------------------------------------------
# traditional -> simplified (reference char_convert.py; data file generated
# by scripts/gen_zh_data.py from the same table)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _t2s_table() -> dict[int, str]:
    path = os.path.join(os.path.dirname(__file__), "data", "zh_t2s.json.gz")
    with gzip.open(path, "rt", encoding="utf-8") as f:
        d = json.load(f)
    return {ord(t): s for t, s in zip(d["trad"], d["simp"])}


def traditional_to_simplified(text: str) -> str:
    return text.translate(_t2s_table())


@lru_cache(maxsize=1)
def _s2t_table() -> dict[int, str]:
    path = os.path.join(os.path.dirname(__file__), "data", "zh_t2s.json.gz")
    with gzip.open(path, "rt", encoding="utf-8") as f:
        d = json.load(f)
    return {ord(s): t for t, s in zip(d["trad"], d["simp"])}


def simplified_to_traditional(text: str) -> str:
    return text.translate(_s2t_table())


@lru_cache(maxsize=1)
def traditional_variants_table() -> dict[str, str]:
    """simplified char -> every traditional character that maps to it (a
    simplified character can fold several traditional ones: 发 <- 發/髮)."""
    path = os.path.join(os.path.dirname(__file__), "data", "zh_t2s.json.gz")
    with gzip.open(path, "rt", encoding="utf-8") as f:
        d = json.load(f)
    out: dict[str, str] = {}
    for t, s in zip(d["trad"], d["simp"]):
        if t != s:
            out[s] = out.get(s, "") + t
    return out


# full-width -> half-width maps (reference constants.py)
_F2H = {ord(c) + 65248: ord(c) for c in string.ascii_letters + string.digits}
_F2H[0x3000] = 0x20  # ideographic space


# ---------------------------------------------------------------------------
# rule passes, in the reference's application order
# ---------------------------------------------------------------------------

_NUM = r"(-?)(\d+(?:\.\d+)?)"

RE_DATE = re.compile(r"(\d{4}|\d{2})年((0?[1-9]|1[0-2])月)?(((0?[1-9])|((1|2)[0-9])|30|31)([日号]))?")
RE_DATE2 = re.compile(r"(\d{4})([- /.])(0[1-9]|1[012])\2(0[1-9]|[12][0-9]|3[01])")
_T = r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
RE_TIME = re.compile(_T)
RE_TIME_RANGE = re.compile(_T + r"(~|-)" + _T)
RE_TEMPERATURE = re.compile(r"(-?)(\d+(\.\d+)?)(°C|℃|度|摄氏度)")
# measure abbreviations; replacement is sequential in this order (longest
# compound units first, reference quantifier.py measure_dict iteration order)
_MEASURES = [
    ("cm2", "平方厘米"), ("cm²", "平方厘米"), ("cm3", "立方厘米"), ("cm³", "立方厘米"),
    ("cm", "厘米"), ("db", "分贝"), ("ds", "毫秒"), ("kg", "千克"), ("km", "千米"),
    ("m2", "平方米"), ("m²", "平方米"), ("m³", "立方米"), ("m3", "立方米"),
    ("ml", "毫升"), ("m", "米"), ("mm", "毫米"), ("s", "秒"),
]
_UNIT_ALT = r"%|°C|℃|度|摄氏度|cm2|cm²|cm3|cm³|cm|db|ds|kg|km|m2|m²|m³|m3|ml|m|mm|s"
RE_TO_RANGE = re.compile(
    rf"((-?)((\d+)(\.\d+)?)|(\.(\d+)))({_UNIT_ALT})[~]((-?)((\d+)(\.\d+)?)|(\.(\d+)))({_UNIT_ALT})"
)
_SUP = "⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ"
_OPERAND = rf"(?:-?\d+(?:\.\d+)?[{_SUP}]*|\.\d+[{_SUP}]*|[A-Za-z][{_SUP}]*)"
RE_ASMD = re.compile(rf"({_OPERAND})([\+\-\×÷=])({_OPERAND})")
_ASMD_NAMES = {"+": "加", "-": "减", "×": "乘", "÷": "除", "=": "等于"}
RE_POWER = re.compile(rf"[{_SUP}]+")
_SUP_MAP = dict(zip(_SUP, "0123456789xyn"))
RE_FRAC = re.compile(r"(-?)(\d+)/(\d+)")
RE_PERCENT = re.compile(r"(-?)(\d+(\.\d+)?)%")
RE_MOBILE = re.compile(r"(?<!\d)((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})(?!\d)")
RE_LANDLINE = re.compile(r"(?<!\d)((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{6,7})(?!\d)")
RE_400 = re.compile(r"(400)(-)?\d{3}(-)?\d{4}")
RE_RANGE = re.compile(
    rf"(?<![\d\+\-\×÷=])((-?)((\d+)(\.\d+)?))[-~]((-?)((\d+)(\.\d+)?))(?![\d\+\-\×÷=])"
)
RE_NEG_INT = re.compile(r"(-)(\d+)")
RE_VERSION = re.compile(r"((\d+)(\.\d+)(\.\d+)?(\.\d+)+)")
RE_DECIMAL = re.compile(r"(-?)((\d+)(\.\d+))|(\.(\d+))")
# measure words following a bare integer (reference num.py COM_QUANTIFIERS)
_QUANTIFIERS = (
    "(处|台|架|枚|趟|幅|平|方|堵|间|床|株|批|项|例|列|篇|栋|注|亩|封|艘|把|目|套|段|人|所|朵|匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|"
    "顶|丘|棵|只|支|袭|辆|挑|担|颗|壳|窠|曲|墙|群|腔|砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|单|双|对|出|口|头|脚|板|"
    "跳|枝|件|贴|针|线|管|名|位|身|堂|课|本|页|家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|毫|厘|(公)分|分|寸|尺|"
    "丈|里|寻|常|铺|程|(千|分|厘|毫|微)米|米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|"
    "煲|啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|小时|旬|纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|面|片|张|"
    "颗|块|元|(亿|千万|百万|万|千|百)|(亿|千万|百万|万|千|百|美|)元|(亿|千万|百万|万|千|百|十|)吨|(亿|千万|百万|万|千|百|)块|角|毛|分)"
)
RE_QUANTIFIER = re.compile(r"(\d+)([多余几\+])?" + _QUANTIFIERS)
RE_SERIAL = re.compile(r"\d{3}\d*")  # 3+ digit codes read digit-by-digit
RE_NUMBER = re.compile(r"(-?)((\d+)(\.\d+)?)|(\.(\d+))")


def _sub_date(m: re.Match) -> str:
    out = ""
    if m.group(1):
        out += verbalize_digits(m.group(1)) + "年"
    if m.group(3):
        out += verbalize_cardinal(m.group(3)) + "月"
    if m.group(5):
        out += verbalize_cardinal(m.group(5)) + m.group(9)
    return out


def _sub_date2(m: re.Match) -> str:
    return (
        verbalize_digits(m.group(1)) + "年"
        + verbalize_cardinal(m.group(3)) + "月"
        + verbalize_cardinal(m.group(4)) + "日"
    )


def _clock(hour: str, minute: str, second: str | None, half_ref: str) -> str:
    """One h:m(:s) reading; minute 30 reads 半. half_ref preserves the
    reference's quirk of testing the *first* time's minute inside a range
    (chronology.py:81)."""
    out = num2str(hour) + "点"
    if minute.lstrip("0"):
        out += "半" if int(half_ref) == 30 else _zero_padded(minute) + "分"
    if second and second.lstrip("0"):
        out += _zero_padded(second) + "秒"
    return out


def _zero_padded(s: str) -> str:
    """'05' -> 零五 (leading zero read out, chronology.py _time_num2str)."""
    out = num2str(s.lstrip("0"))
    return "零" + out if s.startswith("0") else out


def _sub_time(m: re.Match) -> str:
    out = _clock(m.group(1), m.group(2), m.group(4), half_ref=m.group(2))
    if len(m.groups()) > 5:  # range form
        out += "至" + _clock(m.group(6), m.group(7), m.group(9), half_ref=m.group(2))
    return out


def _sub_temperature(m: re.Match) -> str:
    sign = "零下" if m.group(1) else ""
    unit = "摄氏度" if m.group(4) == "摄氏度" else "度"
    return sign + num2str(m.group(2)) + unit


def _sub_frac(m: re.Match) -> str:
    sign = "负" if m.group(1) else ""
    return f"{sign}{num2str(m.group(3))}分之{num2str(m.group(2))}"


def _sub_percent(m: re.Match) -> str:
    return ("负" if m.group(1) else "") + "百分之" + num2str(m.group(2))


def _sub_mobile(m: re.Match) -> str:
    parts = m.group(0).strip("+").split()
    return "，".join(verbalize_digits(p, alt_one=True) for p in parts)


def _sub_phone(m: re.Match) -> str:
    return "，".join(verbalize_digits(p, alt_one=True) for p in m.group(0).split("-"))


def _sub_number(m: re.Match) -> str:
    if m.group(5):  # bare decimal like '.5'
        return num2str(m.group(5))
    return ("负" if m.group(1) else "") + num2str(m.group(2))


def _sub_range(m: re.Match) -> str:
    first = RE_NUMBER.sub(_sub_number, m.group(1))
    second = RE_NUMBER.sub(_sub_number, m.group(6))
    return f"{first}到{second}"


def _sub_quantifier(m: re.Match) -> str:
    approx = m.group(2) or ""
    if approx == "+":
        approx = "多"
    number = num2str(m.group(1))
    if number == "二":
        number = "两"
    return number + approx + m.group(3)


def _sub_version(m: re.Match) -> str:
    return "".join("点" if c == "." else num2str(c) for c in m.group(1))


# symbol spell-outs applied at the end (reference _post_replace); ① etc.,
# greek letters, and bare math operators
_POST_MAP = {
    "/": "每", "①": "一", "②": "二", "③": "三", "④": "四", "⑤": "五",
    "⑥": "六", "⑦": "七", "⑧": "八", "⑨": "九", "⑩": "十",
    "α": "阿尔法", "β": "贝塔", "γ": "伽玛", "Γ": "伽玛", "δ": "德尔塔",
    "Δ": "德尔塔", "ε": "艾普西龙", "ζ": "捷塔", "η": "依塔", "θ": "西塔",
    "Θ": "西塔", "ι": "艾欧塔", "κ": "喀帕", "λ": "拉姆达", "Λ": "拉姆达",
    "μ": "缪", "ν": "拗", "ξ": "克西", "Ξ": "克西", "ο": "欧米克伦",
    "π": "派", "Π": "派", "ρ": "肉", "ς": "西格玛", "Σ": "西格玛",
    "σ": "西格玛", "τ": "套", "υ": "宇普西龙", "φ": "服艾", "Φ": "服艾",
    "χ": "器", "ψ": "普赛", "Ψ": "普赛", "ω": "欧米伽", "Ω": "欧米伽",
    "+": "加", "-": "减", "×": "乘", "÷": "除", "=": "等",
}
_RE_STRIP_PRE = re.compile(r"[——《》【】<>{}()（）#&@“”^_|\\]")
_RE_STRIP_POST = re.compile(r"[-——《》【】<=>{}()（）#&@“”^_|\\]")
_RE_SENT_SPLIT = re.compile(r"([：、，；。？！,;?!][”’]?)")


def normalize_sentence(sentence: str) -> str:
    s = traditional_to_simplified(sentence).translate(_F2H)
    s = RE_DATE.sub(_sub_date, s)
    s = RE_DATE2.sub(_sub_date2, s)
    s = RE_TIME_RANGE.sub(_sub_time, s)
    s = RE_TIME.sub(_sub_time, s)
    s = RE_TO_RANGE.sub(lambda m: m.group(0).replace("~", "至"), s)
    s = RE_TEMPERATURE.sub(_sub_temperature, s)
    for abbr, name in _MEASURES:
        if abbr in s:
            s = s.replace(abbr, name)
    while RE_ASMD.search(s):
        s = RE_ASMD.sub(lambda m: m.group(1) + _ASMD_NAMES[m.group(2)] + m.group(3), s)
    s = RE_POWER.sub(lambda m: "的" + "".join(_SUP_MAP[c] for c in m.group(0)) + "次方", s)
    s = RE_FRAC.sub(_sub_frac, s)
    s = RE_PERCENT.sub(_sub_percent, s)
    s = RE_MOBILE.sub(_sub_mobile, s)
    s = RE_LANDLINE.sub(_sub_phone, s)
    s = RE_400.sub(_sub_phone, s)
    s = RE_RANGE.sub(_sub_range, s)
    s = RE_NEG_INT.sub(lambda m: "负" + num2str(m.group(2)), s)
    s = RE_VERSION.sub(_sub_version, s)
    s = RE_DECIMAL.sub(_sub_number, s)
    s = RE_QUANTIFIER.sub(_sub_quantifier, s)
    s = RE_SERIAL.sub(lambda m: verbalize_digits(m.group(0), alt_one=True), s)
    s = RE_NUMBER.sub(_sub_number, s)
    for k, v in _POST_MAP.items():
        s = s.replace(k, v)
    return _RE_STRIP_POST.sub("", s)


def split_sentences(text: str) -> list[str]:
    """Sentence split for pure-zh text (reference TextNormalizer._split)."""
    text = text.replace(" ", "")
    text = _RE_STRIP_PRE.sub("", text)
    text = _RE_SENT_SPLIT.sub(r"\1\n", text).strip()
    return [s.strip() for s in re.split(r"\n+", text)]


def normalize_sentences(text: str) -> list[str]:
    return [normalize_sentence(s) for s in split_sentences(text)]


def normalize_zh(text: str) -> str:
    return "".join(normalize_sentences(text))


# tone sandhi moved to text/tone_sandhi.py (word-level rule set); this
# re-export keeps older imports working
from gpt_sovits_tpu_torch.text.tone_sandhi import apply_tone_sandhi  # noqa: E402,F401
