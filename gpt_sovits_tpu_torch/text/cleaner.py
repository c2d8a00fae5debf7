"""Language router: clean_text dispatch (ref text/cleaner.py:21-55).

A copy of gpt_sovits_tpu/text/cleaner.py.

clean_text(text, language, version) -> (phones, word2ph, norm_text)
word2ph is phones-per-character for BERT feature alignment (zh only;
None for other languages, matching the reference)."""

from __future__ import annotations

from gpt_sovits_tpu_torch.text import cleaned_text_to_sequence, get_symbols
from gpt_sovits_tpu_torch.text.chinese import clean_text_zh
from gpt_sovits_tpu_torch.text.english import clean_text_en

LANGUAGES = ("zh", "en", "ja", "ko", "yue", "auto")

# special silence symbols: the marker char becomes a dedicated pause phone
# (ref cleaner.py:13-17 + clean_special:58-83)
SPECIAL = (("￥", "zh", "SP2"), ("^", "zh", "SP3"))


def clean_text(text: str, language: str, version: str = "v2"):
    language = language.replace("all_", "")
    for marker, lang, target in SPECIAL:
        if marker in text and language == lang:
            phones, word2ph, norm = clean_text(text.replace(marker, ","), language, version)
            phones = [target if p == "," else p for p in phones]
            return phones, word2ph, norm
    if language == "zh":
        phones, word2ph, norm = clean_text_zh(text)
    elif language == "en":
        phones, norm = clean_text_en(text)
        word2ph = None
    elif language == "ja":
        from gpt_sovits_tpu_torch.text.japanese import clean_text_ja

        phones, norm = clean_text_ja(text)
        word2ph = None
    elif language == "ko":
        from gpt_sovits_tpu_torch.text.korean import clean_text_ko

        phones, norm = clean_text_ko(text)
        word2ph = None
    elif language == "yue":
        from gpt_sovits_tpu_torch.text.cantonese import clean_text_yue

        phones, word2ph, norm = clean_text_yue(text)
    else:
        raise ValueError(f"unknown language {language!r}")
    # UNK fallback (ref cleaner.py:38-44)
    symbols = set(get_symbols(version))
    phones = [p if p in symbols else "UNK" for p in phones]
    return phones, word2ph, norm


def text_to_sequence(text: str, language: str, version: str = "v2") -> list[int]:
    phones, _, _ = clean_text(text, language, version)
    return cleaned_text_to_sequence(phones, version)
