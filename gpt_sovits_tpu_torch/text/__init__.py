"""Text frontend: symbols and sequence conversion.

A copy of gpt_sovits_tpu/text/__init__.py (the port imports nothing of the
JAX package). Counterpart of reference GPT_SoVITS/text/__init__.py +
symbols.py/symbols2.py.
The phoneme inventories are loaded from symbol_tables.json (vocabulary data
extracted for checkpoint compatibility: v1=322 symbols, v2=732 symbols).
"""

from __future__ import annotations

import functools
import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def get_symbols(version: str = "v2") -> list[str]:
    with open(os.path.join(_HERE, "symbol_tables.json"), encoding="utf-8") as f:
        tables = json.load(f)
    return tables["v1" if version == "v1" else "v2"]


@functools.lru_cache(maxsize=None)
def symbol_to_id(version: str = "v2") -> dict[str, int]:
    return {s: i for i, s in enumerate(get_symbols(version))}


def cleaned_text_to_sequence(cleaned_text: list[str], version: str = "v2") -> list[int]:
    """Phone strings -> ids; unknown phones map to UNK (ref text/__init__.py)."""
    table = symbol_to_id(version)
    unk = table.get("UNK")
    return [table.get(s, unk) for s in cleaned_text]
