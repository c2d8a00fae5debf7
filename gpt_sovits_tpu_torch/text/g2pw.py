"""g2pW polyphone disambiguation for Chinese, over the port's ONNX executor.

Port of gpt_sovits_tpu/text/g2pw.py. Counterpart of GPT_SoVITS/text/g2pw/
(onnx_api.py:82 `G2PWOnnxConverter`, dataset.py `prepare_onnx_input`,
utils.py token maps): a BERT-based classifier (distributed as
G2PWModel/g2pW.onnx) picks the right reading for polyphonic hanzi;
monophonic chars come from a dictionary; everything else falls back to the
base pinyin converter.

Differences from the reference:
- the ONNX graph runs through utils/onnx_lite.py (torch, on the card unless
  the caller passes device="cpu") instead of onnxruntime;
- variable-length query batches are attention-mask padded instead of
  relying on equal-length inputs;
- the bundled `config.py` is parsed with ast.literal_eval line-by-line
  instead of being exec()'d (it is downloaded content).

Usage is gated: call `enable(model_dir, tokenizer)` (needs the G2PWModel
bundle + a BERT tokenizer, e.g. text/bert_tokenizer.py over the
chinese-roberta vocab.txt) and text/chinese.py routes hanzi pinyin through
`correct()`.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Optional

import numpy as np

# curated exception sets (onnx_api.py:120-142)
NON_POLYPHONIC = {"一", "不", "和", "咋", "嗲", "剖", "差", "攢", "倒", "難", "奔", "勁", "拗", "肖", "瘙", "誒", "泊", "听", "噢"}
NON_MONOPHONIC = {"似", "攢"}
ANCHOR_TOKENS = ("[CLS]", "[SEP]")


def _parse_config(path: str) -> dict:
    """Parse `name = literal` lines of the bundle's config.py safely."""
    cfg = {"use_mask": True, "use_char_phoneme": False, "model_source": None, "window_size": 32}
    if os.path.exists(path):
        for line in open(path, encoding="utf-8"):
            m = re.match(r"^\s*(\w+)\s*=\s*(.+?)\s*$", line)
            if m:
                try:
                    cfg[m.group(1)] = ast.literal_eval(m.group(2))
                except (ValueError, SyntaxError):
                    pass
    return cfg


def get_phoneme_labels(polyphonic_chars: list[list[str]]) -> tuple[list[str], dict[str, list[int]]]:
    labels = sorted({ph for _, ph in polyphonic_chars})
    char2phonemes: dict[str, list[int]] = {}
    for char, ph in polyphonic_chars:
        char2phonemes.setdefault(char, []).append(labels.index(ph))
    return labels, char2phonemes


def get_char_phoneme_labels(polyphonic_chars: list[list[str]]) -> tuple[list[str], dict[str, list[int]]]:
    labels = sorted({f"{c} {p}" for c, p in polyphonic_chars})
    char2phonemes: dict[str, list[int]] = {}
    for char, ph in polyphonic_chars:
        char2phonemes.setdefault(char, []).append(labels.index(f"{char} {ph}"))
    return labels, char2phonemes


def wordize_and_map(text: str):
    """Split into per-char words with ascii runs kept whole (utils.py:23)."""
    words, text2word, word2text = [], [], []
    pos = 0
    for m in re.finditer(r"[a-zA-Z0-9]+| +|.", text):
        s = m.group(0)
        if s.isspace():
            text2word += [None] * len(s)
            continue
        start = m.start()
        word2text.append((start, start + len(s)))
        text2word += [len(words)] * len(s)
        words.append(s)
    del pos
    return words, text2word, word2text


def tokenize_and_map(tokenizer, text: str):
    """chars <-> wordpiece tokens index maps (utils.py:59)."""
    words, text2word, word2text = wordize_and_map(text)
    tokens, token2text = [], []
    for word, (ws, we) in zip(words, word2text):
        wt = tokenizer.tokenize(word)
        if not wt or wt == ["[UNK]"]:
            token2text.append((ws, we))
            tokens.append("[UNK]")
        else:
            cur = ws
            for t in wt:
                ln = len(re.sub(r"^##", "", t))
                token2text.append((cur, cur + ln))
                cur += ln
                tokens.append(t)
    text2token = list(text2word)
    for i, (ts, te) in enumerate(token2text):
        for p in range(ts, te):
            text2token[p] = i
    return tokens, text2token, token2text


class G2PW:
    """Loads a G2PWModel bundle; callable on sentences like the reference."""

    def __init__(self, model_dir: str, tokenizer, style: str = "pinyin", device=None):
        from gpt_sovits_tpu_torch.utils.onnx_lite import OnnxModel

        self.model = OnnxModel.from_file(os.path.join(model_dir, "g2pW.onnx"), device=device)
        self.tokenizer = tokenizer
        self.config = _parse_config(os.path.join(model_dir, "config.py"))

        def read_pairs(name):
            with open(os.path.join(model_dir, name), encoding="utf-8") as f:
                return [line.split("\t") for line in f.read().strip().split("\n")]

        self.polyphonic_chars = read_pairs("POLYPHONIC_CHARS.txt")
        self.monophonic_chars = read_pairs("MONOPHONIC_CHARS.txt")
        labelfn = get_char_phoneme_labels if self.config["use_char_phoneme"] else get_phoneme_labels
        self.labels, self.char2phonemes = labelfn(self.polyphonic_chars)
        self.chars = sorted(self.char2phonemes.keys())
        self.polyphonic_set = set(self.chars) - NON_POLYPHONIC
        self.monophonic_dict = {c: p for c, p in self.monophonic_chars if c not in NON_MONOPHONIC}

        with open(os.path.join(model_dir, "bopomofo_to_pinyin_wo_tune_dict.json"), encoding="utf-8") as f:
            self.bopomofo_convert_dict = json.load(f)
        cbd = os.path.join(model_dir, "char_bopomofo_dict.json")
        self.char_bopomofo_dict = json.load(open(cbd, encoding="utf-8")) if os.path.exists(cbd) else {}

        self.style_convert = (lambda x: x) if style == "bopomofo" else self._bopomofo_to_pinyin

    def _bopomofo_to_pinyin(self, bopomofo: Optional[str]) -> Optional[str]:
        if bopomofo is None:
            return None
        tone = bopomofo[-1]
        if tone not in "12345":
            return None
        comp = self.bopomofo_convert_dict.get(bopomofo[:-1])
        return comp + tone if comp else None

    # -- batch model inference ------------------------------------------------

    def _predict(self, texts: list[str], query_ids: list[int]) -> list[Optional[str]]:
        n_labels = len(self.labels)
        rows = []
        for text, qid in zip(texts, query_ids):
            text = text.lower()
            tokens, text2token, token2text = tokenize_and_map(self.tokenizer, text)
            tokens = tokens[:510]
            ids = self.tokenizer.convert_tokens_to_ids(["[CLS]"] + tokens + ["[SEP]"])
            qchar = text[qid]
            pmask = np.zeros(n_labels, np.float32)
            if self.config["use_mask"]:
                pmask[self.char2phonemes[qchar]] = 1.0
            else:
                pmask[:] = 1.0
            rows.append(
                dict(ids=ids, pmask=pmask, char_id=self.chars.index(qchar), pos=(text2token[qid] or 0) + 1)
            )
        maxlen = max(len(r["ids"]) for r in rows)
        pad_id = self.tokenizer.convert_tokens_to_ids(["[PAD]"])[0]
        input_ids = np.full((len(rows), maxlen), pad_id, np.int64)
        attn = np.zeros((len(rows), maxlen), np.int64)
        for i, r in enumerate(rows):
            input_ids[i, : len(r["ids"])] = r["ids"]
            attn[i, : len(r["ids"])] = 1
        feeds = {
            "input_ids": input_ids,
            "token_type_ids": np.zeros_like(input_ids),
            "attention_mask": attn,
            "phoneme_mask": np.stack([r["pmask"] for r in rows]),
            "char_ids": np.asarray([r["char_id"] for r in rows], np.int64),
            "position_ids": np.asarray([r["pos"] for r in rows], np.int64),
        }
        probs = self.model.run({k: v for k, v in feeds.items() if k in self.model.input_names} or feeds)[0]
        probs = probs.float().cpu().numpy()
        preds = probs.argmax(axis=1)
        out = []
        for p in preds:
            lab = self.labels[int(p)]
            if self.config["use_char_phoneme"]:
                lab = lab.split(" ")[1]
            out.append(self.style_convert(lab))
        return out

    def __call__(self, sentences: list[str] | str) -> list[list[Optional[str]]]:
        if isinstance(sentences, str):
            sentences = [sentences]
        texts, query_ids, sent_ids = [], [], []
        results: list[list[Optional[str]]] = []
        for sid, sent in enumerate(sentences):
            partial: list[Optional[str]] = [None] * len(sent)
            for i, ch in enumerate(sent):
                if ch in self.polyphonic_set:
                    texts.append(sent)
                    query_ids.append(i)
                    sent_ids.append(sid)
                elif ch in self.monophonic_dict:
                    partial[i] = self.style_convert(self.monophonic_dict[ch])
            results.append(partial)
        if texts:
            preds = self._predict(texts, query_ids)
            for sid, qid, pred in zip(sent_ids, query_ids, preds):
                if pred is not None:
                    results[sid][qid] = pred
        return results

    def correct(self, text: str, base: list[str]) -> list[str]:
        """Overlay model/monophonic readings on a base per-char pinyin list."""
        fixed = self([text])[0]
        return [f if f is not None else b for f, b in zip(fixed, base)]


_ACTIVE: Optional[G2PW] = None


def enable(model_dir: str, tokenizer, device=None) -> G2PW:
    """Install a process-global G2PW used by text/chinese.py; its graph runs
    on `device` (None: the card)."""
    global _ACTIVE
    _ACTIVE = G2PW(model_dir, tokenizer, device=device)
    return _ACTIVE


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[G2PW]:
    return _ACTIVE
