"""Dataset feature-extraction stages (a copy of
gpt_sovits_tpu/prepare/extract.py on the port's audio I/O and text
frontend).

Re-design of GPT_SoVITS/prepare_datasets/{1-get-text,2-get-hubert-wav32k,
2-get-sv,3-get-semantic}.py: instead of N subprocesses sharded by env vars
(webui.py:1082-1096), these are plain functions over a `.list` manifest
(`path|speaker|LANG|text` lines, the ASR output format) with an optional
(part, num_parts) shard argument. The models run behind the callables the
caller passes (run.py `run_prepare`).

Outputs land in exp_dir with the reference's artifact layout (see
train/data.py docstring).
"""

from __future__ import annotations

import os
import traceback
from dataclasses import dataclass
from typing import Optional

import numpy as np

from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, resample, save_wav
from gpt_sovits_tpu_torch.text.cleaner import clean_text


@dataclass
class ListItem:
    path: str
    speaker: str
    lang: str
    text: str

    @property
    def name(self) -> str:
        return os.path.basename(self.path)


def read_manifest(list_file: str) -> list[ListItem]:
    items = []
    with open(list_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("|")
            if len(parts) != 4:
                continue
            items.append(ListItem(parts[0], parts[1], parts[2].lower(), parts[3]))
    return items


def _shard(items, part: int, num_parts: int):
    return items[part::num_parts]


def prepare_text(
    list_file: str,
    exp_dir: str,
    *,
    version: str = "v2",
    bert_fn=None,  # callable(norm_text, word2ph) -> (T_phones, 1024) or None
    part: int = 0,
    num_parts: int = 1,
) -> int:
    """Stage 1a (ref 1-get-text.py): g2p + BERT features."""
    os.makedirs(os.path.join(exp_dir, "3-bert"), exist_ok=True)
    out_path = os.path.join(exp_dir, f"2-name2text-{part}.txt")
    n = 0
    with open(out_path, "w", encoding="utf-8") as out:
        for item in _shard(read_manifest(list_file), part, num_parts):
            try:
                lang = {"zh": "zh", "en": "en", "ja": "ja", "ko": "ko", "yue": "yue"}.get(item.lang, "auto")
                phones, word2ph, norm = clean_text(item.text.replace("%", "-").replace("¥", ","), lang, version)
                if lang == "zh" and bert_fn is not None and word2ph is not None:
                    feat = np.asarray(bert_fn(norm, word2ph), np.float16)
                    np.save(os.path.join(exp_dir, "3-bert", f"{item.name}.npy"), feat)
                w2p = " ".join(map(str, word2ph)) if word2ph else ""
                out.write(f"{item.name}\t{' '.join(phones)}\t{w2p}\t{norm}\n")
                n += 1
            except Exception:
                print(item.path, traceback.format_exc())
    return n


def merge_text_shards(exp_dir: str, num_parts: int) -> str:
    final = os.path.join(exp_dir, "2-name2text.txt")
    with open(final, "w", encoding="utf-8") as out:
        for p in range(num_parts):
            shard = os.path.join(exp_dir, f"2-name2text-{p}.txt")
            if os.path.exists(shard):
                out.write(open(shard, encoding="utf-8").read())
                os.remove(shard)
    return final


def normalize_wav32k(wav: np.ndarray) -> Optional[np.ndarray]:
    """Dual-scale max normalization (ref 2-get-hubert-wav32k.py:83-88):
    blend of peak-normalized (x0.95x0.5) and raw signal; skip clipped
    inputs (|x|>2.2)."""
    tmp_max = np.abs(wav).max()
    if tmp_max > 2.2 or tmp_max == 0:
        return None
    maxx, alpha = 0.95, 0.5
    return (wav / tmp_max * (maxx * alpha)) + (1 - alpha) * wav


def prepare_audio(
    list_file: str,
    exp_dir: str,
    *,
    hubert_fn,  # callable(wav16 (L,)) -> (T, 768)
    wav_dir: Optional[str] = None,
    part: int = 0,
    num_parts: int = 1,
) -> int:
    """Stage 1b (ref 2-get-hubert-wav32k.py): normalized 32 kHz wav +
    CNHuBERT features."""
    wav32_dir = os.path.join(exp_dir, "5-wav32k")
    ssl_dir = os.path.join(exp_dir, "4-cnhubert")
    os.makedirs(wav32_dir, exist_ok=True)
    os.makedirs(ssl_dir, exist_ok=True)
    n = 0
    for item in _shard(read_manifest(list_file), part, num_parts):
        try:
            path = os.path.join(wav_dir, item.name) if wav_dir else item.path
            wav, _ = load_wav(path, sr=32000)
            norm = normalize_wav32k(wav)
            if norm is None:
                print(f"{item.name}: filtered (clipping)")
                continue
            wav16 = resample(norm, 32000, 16000)
            ssl = np.asarray(hubert_fn(wav16), np.float32)
            if np.isnan(ssl).any():
                print(f"{item.name}: NaN features, skipped")
                continue
            save_wav(os.path.join(wav32_dir, item.name), norm, 32000)
            np.save(os.path.join(ssl_dir, f"{item.name}.npy"), ssl.astype(np.float16))
            n += 1
        except Exception:
            print(item.path, traceback.format_exc())
    return n


def prepare_sv(
    list_file: str,
    exp_dir: str,
    *,
    sv_fn,  # callable(wav16 (L,)) -> (20480,)
    part: int = 0,
    num_parts: int = 1,
) -> int:
    """Stage 1b-sv (ref 2-get-sv.py), v2Pro only."""
    sv_dir = os.path.join(exp_dir, "7-sv_cn")
    os.makedirs(sv_dir, exist_ok=True)
    n = 0
    for item in _shard(read_manifest(list_file), part, num_parts):
        wav_path = os.path.join(exp_dir, "5-wav32k", item.name)
        if not os.path.exists(wav_path):
            continue
        wav, _ = load_wav(wav_path)
        wav16 = resample(wav, 32000, 16000)
        np.save(os.path.join(sv_dir, f"{item.name}.npy"), np.asarray(sv_fn(wav16), np.float16))
        n += 1
    return n


def prepare_semantic(
    list_file: str,
    exp_dir: str,
    *,
    extract_latent_fn,  # callable(ssl (T,768)) -> (T//2,) int codes
    part: int = 0,
    num_parts: int = 1,
) -> str:
    """Stage 1c (ref 3-get-semantic.py): SSL features -> semantic ids."""
    out_path = os.path.join(exp_dir, f"6-name2semantic-{part}.tsv")
    with open(out_path, "w", encoding="utf-8") as out:
        for item in _shard(read_manifest(list_file), part, num_parts):
            ssl_path = os.path.join(exp_dir, "4-cnhubert", f"{item.name}.npy")
            if not os.path.exists(ssl_path):
                continue
            ssl = np.load(ssl_path).astype(np.float32)
            codes = np.asarray(extract_latent_fn(ssl), np.int32).reshape(-1)
            out.write(f"{item.name}\t{' '.join(map(str, codes))}\n")
    return out_path


def merge_semantic_shards(exp_dir: str, num_parts: int) -> str:
    final = os.path.join(exp_dir, "6-name2semantic.tsv")
    with open(final, "w", encoding="utf-8") as out:
        for p in range(num_parts):
            shard = os.path.join(exp_dir, f"6-name2semantic-{p}.tsv")
            if os.path.exists(shard):
                out.write(open(shard, encoding="utf-8").read())
                os.remove(shard)
    return final


def check_details(list_file: Optional[str] = None, audio_dir: Optional[str] = None, exp_dir: Optional[str] = None) -> list[str]:
    """Dataset sanity checks (tools/my_utils.py check_details): returns a
    list of human-readable problems (empty == ok).

    * list_file/audio_dir: manifest format + first wav resolvable
    * exp_dir: training artifacts present and non-empty
    """
    problems: list[str] = []
    if list_file is not None:
        if not list_file.endswith(".list"):
            problems.append(f"{list_file}: expected a .list manifest")
        elif not os.path.exists(list_file):
            problems.append(f"{list_file}: not found")
        else:
            with open(list_file, encoding="utf-8") as f:
                first = f.readline().strip("\n")
            parts = first.split("|")
            if len(parts) != 4:
                problems.append(f"{list_file}: lines must be wav|speaker|lang|text, got {len(parts)} fields")
            else:
                wav_name = parts[0]
                if audio_dir:
                    if not os.path.isdir(audio_dir):
                        problems.append(f"{audio_dir}: not a directory")
                    wav_name = os.path.join(audio_dir, os.path.basename(wav_name))
                if not os.path.exists(wav_name):
                    problems.append(f"{wav_name}: audio path in manifest does not exist")
    if exp_dir is not None:
        phone_path = os.path.join(exp_dir, "2-name2text.txt")
        if not (os.path.exists(phone_path) and open(phone_path, encoding="utf-8").read(1)):
            problems.append("missing phoneme dataset (2-name2text.txt)")
        for sub, label in (("4-cnhubert", "Hubert features"), ("5-wav32k", "normalized wavs")):
            p = os.path.join(exp_dir, sub)
            if not (os.path.isdir(p) and os.listdir(p)):
                problems.append(f"missing {label} ({sub}/)")
        sem = os.path.join(exp_dir, "6-name2semantic.tsv")
        if not os.path.exists(sem) or sum(1 for _ in open(sem, encoding="utf-8")) < 1:
            problems.append("missing semantic dataset (6-name2semantic.tsv)")
    return problems
