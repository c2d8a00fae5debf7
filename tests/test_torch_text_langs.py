"""The port's zh/ja/ko/yue frontends, language router and run segmenter give
exactly the JAX package's output (the port carries its own copy of these
host modules and their data). Each zh case runs twice: with jieba, and with
jieba blocked on both sides, the case of a deployment without jieba, where
both packages fall back to one character a word."""

import sys

import pytest

from gpt_sovits_tpu.text import cleaned_text_to_sequence as j_seq
from gpt_sovits_tpu.text.cleaner import clean_text as j_clean
from gpt_sovits_tpu.text.lang_segmenter import runs_for_language as j_runs
from gpt_sovits_tpu_torch.serve.api import TTSService
from gpt_sovits_tpu_torch.text import cleaned_text_to_sequence as p_seq
from gpt_sovits_tpu_torch.text.cleaner import clean_text as p_clean
from gpt_sovits_tpu_torch.text.lang_segmenter import runs_for_language as p_runs

ZH = {
    "numbers_dates": [
        "今天是2024年3月5日，气温零下3.5℃，比昨天低了12%。",
        "电话号码是13812345678，会议在下午3:45开始，共有1/3的人迟到。",
        "第1名得了98.5分，2023-12-31之前提交。",
    ],
    "money_percent": [
        "这件衣服打八折后是¥199.99元，我花了$25。",
        "利润增长了35.6%，成本下降了-2.5%。",
    ],
    "erhua": [
        "他在小院儿里玩儿，媳妇儿和女儿都在。",
        "这儿有一点儿花儿，那儿是胡同儿。",
    ],
    "polyphones_sandhi": [
        "银行行长长得很高，重庆的重量很重。",
        "不要不要，一个一个来，你好好想想，我们试试看。",
        "展览馆里有纸老虎，我很好，你也好。",
    ],
    "traditional": [
        "這個軟體的說明書寫得很清楚。",
        "歡迎來到臺灣，請多關照！",
    ],
    "markers_mixed": [
        "我们一起去看看吧￥然后再说^好不好？",
        "我在用iPhone工作，OK吗？",
        "嗯，呣……好的——走吧~",
    ],
}
JA = ["こんにちは、世界。", "東京は日本の首都です。", "カタカナとひらがなを混ぜた文章。", "今日は2024年です！"]
KO = ["안녕하세요, 반갑습니다.", "한국어 음성 합성을 테스트합니다.", "같이 놀자! 국물이 맛있어요."]
YUE = ["你好，我係香港人。", "佢哋今日去咗飲茶，好開心！", "唔該晒，聽日見，3點半。"]

MIXED = [
    "我在用iPhone工作。こんにちは、世界。안녕하세요!",
    "Hello 你好 こんにちは 안녕 world.",
    "今天天气很好, let's go to the park. 東京に行きます。",
    "佢哋今日去咗飲茶 and it was fun.",
    "純粋な日本語の文です。",
]


@pytest.fixture(params=["jieba", "no_jieba"])
def jieba_mode(request, monkeypatch):
    if request.param == "no_jieba":
        monkeypatch.setitem(sys.modules, "jieba", None)
        monkeypatch.setitem(sys.modules, "jieba.posseg", None)
    return request.param


def _same(text: str, lang: str, version: str = "v2"):
    want = j_clean(text, lang, version)
    got = p_clean(text, lang, version)
    assert got == want, (text, lang)
    assert p_seq(got[0], version) == j_seq(want[0], version), text
    return got


@pytest.mark.parametrize("group", sorted(ZH))
def test_clean_text_zh_equal(group, jieba_mode):
    for s in ZH[group]:
        phones, word2ph, norm = _same(s, "zh")
        assert len(phones) == sum(word2ph) and len(word2ph) == len(norm), s


@pytest.mark.parametrize("lang, sentences", [("ja", JA), ("ko", KO), ("yue", YUE)], ids=["ja", "ko", "yue"])
def test_clean_text_other_langs_equal(lang, sentences):
    for s in sentences:
        _same(s, lang)


@pytest.mark.parametrize("mode", list(TTSService.LANGS) + ["auto_yue"])
def test_runs_for_language_equal(mode):
    for s in MIXED + ZH["markers_mixed"] + JA[:1] + KO[:1]:
        assert p_runs(s, mode) == j_runs(s, mode), (mode, s)


def test_unknown_language_raises():
    for clean in (j_clean, p_clean):
        with pytest.raises(ValueError, match="unknown language"):
            clean("text", "xx")
