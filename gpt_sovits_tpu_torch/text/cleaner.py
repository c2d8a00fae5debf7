"""Language router, English route only (gpt_sovits_tpu/text/cleaner.py).

clean_text(text, language, version) -> (phones, word2ph, norm_text).
The zh/ja/ko/yue frontends wait for ROADMAP item M5b; until then those
languages raise NotImplementedError here and in the pipeline.
"""

from __future__ import annotations

from gpt_sovits_tpu_torch.text import get_symbols
from gpt_sovits_tpu_torch.text.english import clean_text_en

LANGUAGES = ("en",)
NOT_PORTED = ("zh", "ja", "ko", "yue", "auto", "auto_yue")


def check_language(language: str) -> None:
    """Raise for a language mode whose frontend the port does not have yet."""
    lang = language.replace("all_", "")
    if lang in NOT_PORTED:
        raise NotImplementedError(
            f"language {language!r}: the zh/ja/ko/yue frontends and BERT features "
            "are not ported yet (ROADMAP.md, Queue 1, M5b)"
        )
    if lang not in LANGUAGES:
        raise ValueError(f"unknown language {language!r}")


def clean_text(text: str, language: str, version: str = "v2"):
    check_language(language)
    phones, norm = clean_text_en(text)
    # UNK fallback (ref cleaner.py:38-44)
    symbols = set(get_symbols(version))
    phones = [p if p in symbols else "UNK" for p in phones]
    return phones, None, norm
