"""The port's English text frontend and cut methods give exactly the JAX
package's output (the port carries its own copy of these host modules)."""

import pytest

from gpt_sovits_tpu.text import cleaned_text_to_sequence as j_seq
from gpt_sovits_tpu.text.cleaner import clean_text as j_clean
from gpt_sovits_tpu.text.lang_segmenter import runs_for_language as j_runs
from gpt_sovits_tpu.text.segmentation import get_method as j_method
from gpt_sovits_tpu.text.segmentation import split_big_text as j_split
from gpt_sovits_tpu_torch.text import cleaned_text_to_sequence as p_seq
from gpt_sovits_tpu_torch.text.cleaner import clean_text as p_clean
from gpt_sovits_tpu_torch.text.lang_segmenter import runs_for_language as p_runs
from gpt_sovits_tpu_torch.text.segmentation import get_method as p_method
from gpt_sovits_tpu_torch.text.segmentation import split_big_text as p_split

SENTENCES = [
    "Hello world.",
    "The quick brown fox jumps over the lazy dog!",
    "Dr. Smith met Mr. Jones at 10:30 on St. Patrick's day.",
    "It costs $12.50, or about 11 euros.",
    "In 1999, 3.14 was rounded to 3; in 2024 nobody cared.",
    "She said: 'no way' -- and left...",
    "Elizabeth, Margaret and Oliver went to Chicago.",
    "I'd've thought you'd know, wouldn't you?",
    "The 21st century began on January 1st, 2001.",
    "Prof. Brown's lab has 1,234,567 samples, etc.",
    "GPU, CPU and TPU are acronyms vs. words.",
    "Numbers like 7, 42 and 100 are common.",
    "Mixed-case WoRdS and hyphen-ated terms.",
    "What? Really! Yes~ okay: fine.",
    "Anna's cat's toys are everywhere.",
    "A sentence with    extra   spaces.",
    "1/2 of the cake, 3/4 of the pie.",
    "He scored 95% on the test, up 5% from May.",
    "Supercalifragilisticexpialidocious is long.",
    "Jr. and Sr. are abbreviations too.",
    "Zyxw qrst: made-up words go through the rules.",
    "The year 1066 and the number 1066 differ?",
    "Call 555-0199 before 9 p.m.",
    "Let's test ellipses… and dashes — here.",
    "Oh, the Wednesday meeting moved to Thursday.",
    "Kayla, Brandon, and Xavier arrived late.",
    "It's 2:45 and 6 o'clock is far.",
    "Version 2.0 replaced version 1.5.",
    "We need 2 apples, 3 pears, and 10 plums.",
    "Is it 'read' or 'red'? Context decides!",
]


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_clean_text_en_equal(version):
    for s in SENTENCES:
        pj, wj, nj = j_clean(s, "en", version)
        pp, wp, np_ = p_clean(s, "en", version)
        assert (pp, wp, np_) == (pj, wj, nj), s
        assert p_seq(pp, version) == j_seq(pj, version), s


@pytest.mark.parametrize("method", ["cut0", "cut1", "cut2", "cut3", "cut4", "cut5"])
def test_cut_methods_equal(method):
    text = " ".join(SENTENCES)
    assert p_method(method)(text) == j_method(method)(text)
    for s in SENTENCES:
        assert p_method(method)(s) == j_method(method)(s), s


def test_split_big_text_equal():
    text = " ".join(SENTENCES * 4)
    for n in (510, 64):
        assert p_split(text, n) == j_split(text, n)


@pytest.mark.parametrize("lang", ["zh", "ja", "ko", "yue", "auto", "all_zh"])
def test_language_modes_route(lang):
    """Each mode that raised NotImplementedError before the zh/ja/ko/yue
    frontends were ported now gives the JAX package's phones: through
    clean_text directly (`auto` is no clean_text language in either package:
    both raise ValueError), and run by run through runs_for_language, as the
    pipeline calls them."""
    text = "我在用iPhone工作，你好。こんにちは。안녕하세요."
    if lang == "auto":
        for clean in (j_clean, p_clean):
            with pytest.raises(ValueError, match="unknown language"):
                clean(text, lang)
    else:
        assert p_clean(text, lang) == j_clean(text, lang)
    runs = p_runs(text, lang)
    assert runs and runs == j_runs(text, lang)
    for run in runs:
        got = p_clean(run["text"], run["lang"])
        assert got == j_clean(run["text"], run["lang"]), run
        assert p_seq(got[0]) == j_seq(got[0])
