"""Mandarin tone sandhi on toned pinyin.

A copy of gpt_sovits_tpu/text/tone_sandhi.py.

Counterpart of the reference text/tone_sandhi.py (774 LoC, the paddlespeech
rule set): neutral-tone rules, 不/一 sandhi and third-tone sandhi, applied
word-by-word over a jieba segmentation (jieba ships in this image; when it
is not importable a character-level fallback applies the context-free
subset of the rules).

The public entry is `apply_tone_sandhi(chars, sylls)`: `chars` is the hanzi
string and `sylls` the per-character toned pinyin (e.g. "hao3"); returns the
adjusted pinyin list.  Rules follow the reference's behavior:

  * neutral tone: reduplicated kin/verb syllables (妈妈/试试), particle
    suffixes (吧/呢/啊…, 的/地/得, 了/着/过, 们/子, 上/下/里, 来/去 after
    motion verbs), quantifier 个 after numerals, and a built-in list of
    common neutral-tone words (ref must_neutral_tone_words)
  * 不: X不X -> neutral; 不 + tone4 -> bu2
  * 一: numeric context keeps yi1; 第一/初一 keep yi1; V一V -> neutral;
    一 + tone4 -> yi2; otherwise yi4
  * third tone: 3-3 -> 2-3 inside words with the 2+1/1+2 split distinction
    (展览馆 -> 2 2 3, 纸老虎 -> 3 2 3), pairwise in 4-char words, and across
    word boundaries (chain 3-3-3 -> 2-2-3)
"""

from __future__ import annotations

import re

# Common neutral-tone vocabulary (second syllable unstressed). This is an
# independently curated list of standard-Mandarin neutral-tone words — the
# linguistic content matches what the reference's must_neutral_tone_words
# covers for frequent words.
NEUTRAL_TONE_WORDS = {
    # kinship
    "妈妈", "爸爸", "哥哥", "弟弟", "妹妹", "姐姐", "奶奶", "爷爷", "叔叔",
    "舅舅", "姑姑", "姥姥", "婶婶", "伯伯", "媳妇", "丈夫", "女婿", "孙子",
    "侄子", "姑娘", "娃娃", "宝宝", "太太", "老婆", "老爷",
    # body
    "脑袋", "耳朵", "鼻子", "嘴巴", "胳膊", "指甲", "头发", "眉毛", "嗓子",
    "肚子", "屁股", "胡子", "辫子", "舌头", "拳头", "骨头", "爪子", "尾巴",
    "翅膀", "眼睛",
    # everyday objects
    "东西", "衣服", "裤子", "袜子", "鞋子", "帽子", "桌子", "椅子", "房子",
    "院子", "村子", "镜子", "筷子", "盘子", "瓶子", "袋子", "箱子", "毯子",
    "被子", "枕头", "馒头", "饺子", "包子", "粽子", "石头", "木头", "砖头",
    "扣子", "扇子", "梯子", "篮子", "绳子", "本子", "册子", "棍子", "车子",
    "担子", "筐子", "罐子", "锤子", "剪子", "刷子", "钉子", "钳子", "嫂子",
    # nature / animals / food
    "月亮", "云彩", "苍蝇", "蚂蚁", "蘑菇", "葡萄", "萝卜", "玻璃", "喇叭",
    "琵琶", "狮子", "猴子", "兔子", "虫子", "燕子", "鸽子", "骆驼", "蛤蟆",
    "石榴", "核桃", "芝麻", "豆腐", "豆子", "种子",
    # verbs / psych
    "喜欢", "明白", "清楚", "知道", "告诉", "商量", "打听", "打扮", "打算",
    "折腾", "收拾", "答应", "吩咐", "嘱咐", "休息", "觉得", "认识", "记得",
    "晓得", "懂得", "舍得", "值得", "咳嗽", "哆嗦", "唠叨", "吆喝", "招呼",
    "张罗", "糊涂", "热闹", "暖和", "凉快", "痛快", "马虎", "利索", "大方",
    "漂亮", "干净", "结实", "壮实", "老实", "规矩", "合同", "伺候", "溜达",
    "琢磨", "嘀咕", "耷拉",
    # abstract
    "力气", "脾气", "运气", "福气", "客气", "名气", "名字", "样子", "事情",
    "消息", "功夫", "工夫", "师傅", "徒弟", "朋友", "亲戚", "客人", "先生",
    "意思", "关系", "学问", "买卖", "便宜", "动静", "队伍", "足迹", "困难",
    "时候", "丫头", "念头", "来头", "甜头", "苗头", "窝囊", "别扭", "包袱",
    "疙瘩", "累赘", "麻烦", "温和", "爽快",
}

# 子-final words where 子 is a full morpheme, NOT a neutral suffix
NOT_NEUTRAL_SUFFIX = {
    "男子", "女子", "分子", "原子", "量子", "莲子", "电子", "粒子", "父子",
    "母子", "孢子", "栗子", "王子", "君子", "卵子", "五倍子",
}

_GRAMMAR_TAILS = set("吧呢啊呐噻嘛吖嗨哦哟喽啰耶喔诶")
_ASPECT_TAILS = set("了着过")
_DE_TAILS = set("的地得")
_LOC_TAILS = set("上下里")
_COME_GO = set("来去")
_MOTION_BEFORE = set("上下进出回过起开")
_NUM_CHARS = set("零一二三四五六七八九十百千万亿两几")
_GE_BEFORE = set("一二三四五六七八九十几有两半多各整每做是零")


def _tone(s: str) -> int:
    return int(s[-1]) if s and s[-1].isdigit() else 0


def _set(s: str, t: int) -> str:
    return s[:-1] + str(t) if s and s[-1].isdigit() else s


def _segment(chars: str):
    """[(word, pos)] via jieba.posseg, else one char per word."""
    try:
        import jieba.posseg as pseg

        return [(w, p) for w, p in pseg.lcut(chars)]
    except Exception:
        return [(c, "x") for c in chars]


def _neural_sandhi(word: str, pos: str, syl: list[str]) -> list[str]:
    n = len(word)
    # reduplicated noun/verb/adjective syllables: 奶奶 / 试试 / 旺旺
    for j in range(1, n):
        if word[j] == word[j - 1] and pos[:1] in ("n", "v", "a"):
            syl[j] = _set(syl[j], 5)
    if n >= 1:
        last = word[-1]
        if last in _GRAMMAR_TAILS or last in _DE_TAILS:
            syl[-1] = _set(syl[-1], 5)
        elif last in _ASPECT_TAILS and pos in ("ul", "uz", "ug", "u"):
            syl[-1] = _set(syl[-1], 5)
        elif last in "们子" and pos[:1] in ("r", "n") and word not in NOT_NEUTRAL_SUFFIX:
            syl[-1] = _set(syl[-1], 5)
        elif last in _LOC_TAILS and pos in ("s", "l", "f"):
            syl[-1] = _set(syl[-1], 5)
        elif last in _COME_GO and n >= 2 and word[-2] in _MOTION_BEFORE:
            syl[-1] = _set(syl[-1], 5)
    # quantifier 个
    for j, ch in enumerate(word):
        if ch == "个" and (j > 0 and word[j - 1] in _GE_BEFORE or word == "个"):
            syl[j] = _set(syl[j], 5)
    # word list
    if word in NEUTRAL_TONE_WORDS:
        syl[-1] = _set(syl[-1], 5)
    elif n >= 2 and word[-2:] in NEUTRAL_TONE_WORDS:
        syl[-1] = _set(syl[-1], 5)
    return syl


def _bu_sandhi(word: str, syl: list[str]) -> list[str]:
    n = len(word)
    if n == 3 and word[1] == "不" and word[0] == word[2]:
        syl[1] = _set(syl[1], 5)  # 好不好
        return syl
    for j, ch in enumerate(word):
        if ch == "不" and j + 1 < n and _tone(syl[j + 1]) == 4:
            syl[j] = _set(syl[j], 2)
    return syl


def _yi_sandhi(word: str, syl: list[str]) -> list[str]:
    n = len(word)
    if "一" not in word:
        return syl
    # purely numeric context (serials, numbers): keep yi1
    others = [c for c in word if c != "一"]
    if others and all(c in _NUM_CHARS or c.isdigit() for c in others):
        return syl
    if word.startswith(("第", "初")):
        return syl
    for j, ch in enumerate(word):
        if ch != "一":
            continue
        if 0 < j < n - 1 and word[j - 1] == word[j + 1]:
            syl[j] = _set(syl[j], 5)  # 看一看
        elif j + 1 < n:
            syl[j] = _set(syl[j], 2 if _tone(syl[j + 1]) == 4 else 4)
    return syl


def _split_word(word: str) -> tuple[str, str]:
    """Sub-word split for 3-char third-tone sandhi (ref _split_word via
    jieba.cut_for_search): returns the (first, rest) morpheme split."""
    try:
        import jieba

        parts = sorted(jieba.cut_for_search(word), key=len)
        for p in parts:
            if len(p) < len(word) and word.startswith(p):
                return p, word[len(p):]
            if len(p) < len(word) and word.endswith(p):
                return word[: -len(p)], p
    except Exception:
        pass
    return word[:1], word[1:]


def _three_sandhi(word: str, syl: list[str]) -> list[str]:
    tones = [_tone(s) for s in syl]
    n = len(word)
    if n == 2 and tones == [3, 3]:
        syl[0] = _set(syl[0], 2)
    elif n == 3 and tones == [3, 3, 3]:
        first, _rest = _split_word(word)
        if len(first) == 2:  # 展览+馆 -> 2 2 3
            syl[0] = _set(syl[0], 2)
            syl[1] = _set(syl[1], 2)
        else:  # 纸+老虎 -> 3 2 3
            syl[1] = _set(syl[1], 2)
    elif n == 3:
        for j in range(1, n):
            if tones[j] == 3 and tones[j - 1] == 3:
                syl[j - 1] = _set(syl[j - 1], 2)
    elif n == 4 and all(t == 3 for t in tones):
        syl[0] = _set(syl[0], 2)
        syl[2] = _set(syl[2], 2)
    else:
        orig = list(tones)
        for j in range(n - 1):
            if orig[j] == 3 and orig[j + 1] == 3:
                syl[j] = _set(syl[j], 2)
    return syl


def _word_tones(word: str) -> list[int]:
    """Lexicon tones per char (pre-sandhi); [] for non-hanzi words."""
    from gpt_sovits_tpu_torch.text.chinese import _word_pinyin

    if not _HANZI.search(word):
        return []
    return [_tone(s) for s in _word_pinyin(word)]


def _merge_bu(words: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """Standalone 不 attaches to the following word (ref _merge_bu)."""
    out: list[tuple[str, str]] = []
    last = ""
    for w, p in words:
        if last == "不":
            w = last + w
        if w != "不":
            out.append((w, p))
        last = w
    if last == "不":
        out.append((last, "d"))
    return out


def _merge_yi(words: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """V 一 V re-joined across words; then standalone 一 attaches to the
    following word (ref _merge_yi)."""
    merged: list[tuple[str, str]] = []
    i = 0
    while i < len(words):
        w, p = words[i]
        if (
            w == "一"
            and i > 0
            and i + 1 < len(words)
            and merged
            and merged[-1][0] == words[i + 1][0]
            and merged[-1][1] == "v"
            and words[i + 1][1] == "v"
        ):
            merged[-1] = (merged[-1][0] + "一" + words[i + 1][0], merged[-1][1])
            i += 2
            continue
        merged.append((w, p))
        i += 1
    out: list[tuple[str, str]] = []
    for w, p in merged:
        if out and out[-1][0] == "一":
            out[-1] = (out[-1][0] + w, out[-1][1])
        else:
            out.append((w, p))
    return out


def _merge_reduplication(words: list[tuple[str, str]]) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    for w, p in words:
        if out and w == out[-1][0]:
            out[-1] = (out[-1][0] + w, out[-1][1])
        else:
            out.append((w, p))
    return out


def _merge_three_tones(words: list[tuple[str, str]], boundary_only: bool) -> list[tuple[str, str]]:
    """Join adjacent short words for the third-tone rules: either both words
    entirely tone 3, or just the boundary syllables tone 3 (ref
    _merge_continuous_three_tones / _2). Reduplications stay split so the
    neutral-tone rule still sees them; merged result capped at 3 chars."""
    tones = [_word_tones(w) for w, _ in words]
    out: list[tuple[str, str]] = []
    merged_prev = False
    for i, (w, p) in enumerate(words):
        if i > 0 and not merged_prev and tones[i - 1] and tones[i]:
            if boundary_only:
                joinable = tones[i - 1][-1] == 3 and tones[i][0] == 3
            else:
                joinable = all(t == 3 for t in tones[i - 1]) and all(t == 3 for t in tones[i])
            prev_w = words[i - 1][0]
            if joinable and not (len(prev_w) == 2 and prev_w[0] == prev_w[1]) and len(prev_w) + len(w) <= 3:
                out[-1] = (out[-1][0] + w, out[-1][1])
                merged_prev = True
                continue
        out.append((w, p))
        merged_prev = False
    return out


def _merge_er(words: list[tuple[str, str]]) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    for i, (w, p) in enumerate(words):
        if i > 0 and w == "儿" and words[i - 1][0] != "#":
            out[-1] = (out[-1][0] + w, out[-1][1])
        else:
            out.append((w, p))
    return out


def _pre_merge(words: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """Merge segmentation artifacts before the rules run (ref
    pre_merge_for_modify): 不/一 attachment, reduplications, continuous
    third-tone runs, trailing 儿."""
    words = _merge_bu(words)
    words = _merge_yi(words)
    words = _merge_reduplication(words)
    words = _merge_three_tones(words, boundary_only=False)
    words = _merge_three_tones(words, boundary_only=True)
    words = _merge_er(words)
    return words


def modified_tone(word: str, pos: str, sylls: list[str]) -> list[str]:
    """All four sandhi rule families on one word's toned pinyin, in the
    reference's order (tone_sandhi.py:769-774)."""
    sylls = _bu_sandhi(word, sylls)
    sylls = _yi_sandhi(word, sylls)
    sylls = _neural_sandhi(word, pos, sylls)
    sylls = _three_sandhi(word, sylls)
    return sylls


_HANZI = re.compile(r"[一-鿿]")


def apply_tone_sandhi(chars: str, sylls: list[str]) -> list[str]:
    """Word-level sandhi over the hanzi/pinyin pair; the two sequences must
    be 1:1 aligned (non-hanzi entries pass through untouched)."""
    if len(sylls) != len(chars):
        return sylls  # not per-char aligned; skip (punctuation-stripped path)
    out = list(sylls)
    words = _pre_merge(_segment(chars))
    # per-word rules
    i = 0
    spans = []
    for word, pos in words:
        j = i + len(word)
        spans.append((word, pos, i, j))
        i = j
    if i != len(chars):  # segmentation drift; char-level fallback
        spans = [(c, "x", k, k + 1) for k, c in enumerate(chars)]
    for word, pos, a, b in spans:
        if not _HANZI.search(word):
            continue
        seg = out[a:b]
        seg = _neural_sandhi(word, pos, seg)
        seg = _bu_sandhi(word, seg)
        seg = _yi_sandhi(word, seg)
        seg = _three_sandhi(word, seg)
        out[a:b] = seg
    # cross-word third-tone chain (ref merges continuous three-tones before
    # the per-word pass; the boundary rule is equivalent for the chain case)
    orig = [_tone(s) for s in out]
    for j in range(len(out) - 1):
        if orig[j] == 3 and orig[j + 1] == 3 and _tone(out[j]) == 3:
            out[j] = _set(out[j], 2)
    return out
