"""Datasets and bucketed batching for S1, S2 and v3/v4 training (port of
gpt_sovits_tpu/train/data.py). S2Dataset and V3Dataset read a batch's WAV
and SSL files with the native batch reader (native.py, csrc/gsvt_io.cc)
where it builds, and with Python otherwise, as the JAX package does.

On-disk layout of a prepared experiment (the reference's logs/{exp}/):
  2-name2text.txt        name\\tphones (space-separated)\\tword2ph\\tnorm_text
  3-bert/{name}.npy      (T_phones, 1024) float16, zh only
  4-cnhubert/{name}.npy  (T_ssl, 768) float16
  5-wav32k/{name}        normalized 32 kHz wav (names carry `.wav`)
  6-name2semantic.tsv    name\\tsemantic ids (space-separated)
  7-sv_cn/{name}.npy     (20480,) float16, v2Pro/v2ProPlus only

The samplers draw from numpy with the JAX package's seeds, so an epoch's
batches are the JAX package's, index for index; collates return numpy
arrays (`batch_to` moves them to a device).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from gpt_sovits_tpu_torch import native
from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, resample
from gpt_sovits_tpu_torch.dsp.mel import mel_spectrogram, norm_spec, spectrogram
from gpt_sovits_tpu_torch.text import cleaned_text_to_sequence
from gpt_sovits_tpu_torch.utils.config import MEL_V3, MEL_V4, MelConfig


def read_name2text(path: str) -> dict[str, list[str]]:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[parts[0]] = parts[1].split(" ")
    return out


def read_name2semantic(path: str) -> dict[str, np.ndarray]:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 2 and parts[1]:
                out[parts[0]] = np.asarray([int(x) for x in parts[1].split(" ")], np.int32)
    return out


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class BucketSampler:
    """Length-bucketed batches (ref AR/data/bucket_sampler.py:20 and
    module/data_utils.py:982): items grouped by length // bucket_width,
    shuffled within buckets and then as batches with numpy's generator at
    seed + epoch; a bucket's remainder short of a batch is dropped; shards
    take equal batch counts."""

    def __init__(self, lengths: Sequence[int], batch_size: int, *, seed: int = 1234, num_shards: int = 1,
                 shard_id: int = 0, bucket_width: int = 50):
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.bucket_width = bucket_width

    def epoch_batches(self, epoch: int) -> list[np.ndarray]:
        rng = np.random.default_rng(self.seed + epoch)
        order = np.argsort(self.lengths, kind="stable")
        buckets: dict[int, list[int]] = {}
        for i in order:
            buckets.setdefault(int(self.lengths[i]) // self.bucket_width, []).append(int(i))
        batches = []
        for _, idxs in sorted(buckets.items()):
            idxs = np.asarray(idxs)
            rng.shuffle(idxs)
            for s in range(0, len(idxs) - self.batch_size + 1, self.batch_size):
                batches.append(idxs[s : s + self.batch_size])
        rng.shuffle(batches)
        n = len(batches) // self.num_shards * self.num_shards
        return batches[:n][self.shard_id :: self.num_shards]


@dataclass
class S1Example:
    name: str
    phoneme_ids: np.ndarray
    semantic_ids: np.ndarray
    bert: Optional[np.ndarray]


class S1Dataset:
    """Phoneme and semantic tables joined (ref AR/data/dataset.py:40),
    filtered to at most max_sec seconds and 3-25 phonemes a second."""

    def __init__(self, exp_dir: str, *, version: str = "v2", max_sec: int = 54, frame_rate: int = 25,
                 bert_dim: int = 1024):
        self.exp_dir = exp_dir
        self.bert_dim = bert_dim
        texts = read_name2text(os.path.join(exp_dir, "2-name2text.txt"))
        semantics = read_name2semantic(os.path.join(exp_dir, "6-name2semantic.tsv"))
        self.items: list[S1Example] = []
        for name, phones in texts.items():
            if name not in semantics:
                continue
            sem = semantics[name]
            sec = len(sem) / frame_rate
            if sec > max_sec or sec <= 0:
                continue
            if not (3 <= len(phones) / max(sec, 1e-6) <= 25):
                continue
            ids = np.asarray(cleaned_text_to_sequence(phones, version), np.int32)
            bert_path = os.path.join(exp_dir, "3-bert", f"{name}.npy")
            bert = np.load(bert_path).astype(np.float32) if os.path.exists(bert_path) else None
            self.items.append(S1Example(name, ids, sem, bert))

    def __len__(self):
        return len(self.items)

    def lengths(self) -> list[int]:
        return [len(it.semantic_ids) for it in self.items]

    def collate(self, idxs: Sequence[int], buckets=(128, 256, 512, 1024, 1536)) -> dict:
        """Phonemes LEFT-padded, semantic ids RIGHT-padded (models/t2s.py)."""
        items = [self.items[i] for i in idxs]
        tx = _next_bucket(max(len(it.phoneme_ids) for it in items), buckets)
        ty = _next_bucket(max(len(it.semantic_ids) for it in items), buckets)
        b = len(items)
        phones = np.zeros((b, tx), np.int32)
        bert = np.zeros((b, tx, self.bert_dim), np.float32)
        sems = np.zeros((b, ty), np.int32)
        x_lens = np.zeros((b,), np.int32)
        y_lens = np.zeros((b,), np.int32)
        for i, it in enumerate(items):
            n = len(it.phoneme_ids)
            phones[i, tx - n :] = it.phoneme_ids
            if it.bert is not None:
                bert[i, tx - n :] = it.bert[:n]
            m = len(it.semantic_ids)
            sems[i, :m] = it.semantic_ids
            x_lens[i] = n
            y_lens[i] = m
        return {"phoneme_ids": phones, "phoneme_lens": x_lens, "semantic_ids": sems, "semantic_lens": y_lens,
                "bert_features": bert}


class S2Dataset:
    """S2 GAN training data (ref module/data_utils.py
    TextAudioSpeakerLoader): the linear spectrogram computed from the 32 kHz
    wav, the wav, SSL features, phoneme ids and, where `7-sv_cn` has them,
    the speaker-verification embeddings (v2Pro/v2ProPlus)."""

    def __init__(self, exp_dir: str, *, version: str = "v2", mel_cfg: MelConfig = MelConfig(),
                 min_frames: int = 64, max_frames: int = 1600):
        self.exp_dir = exp_dir
        self.mel_cfg = mel_cfg
        self.version = version
        texts = read_name2text(os.path.join(exp_dir, "2-name2text.txt"))
        self.names = []
        self.phones = {}
        self._frames = []
        for name, ph in texts.items():
            wav_path = os.path.join(exp_dir, "5-wav32k", name)
            ssl_path = os.path.join(exp_dir, "4-cnhubert", f"{name}.npy")
            if not (os.path.exists(wav_path) and os.path.exists(ssl_path)):
                continue
            n_frames = os.path.getsize(wav_path) // 2 // mel_cfg.hop_size  # pcm16
            if not (min_frames <= n_frames <= max_frames):
                continue
            self.names.append(name)
            self.phones[name] = np.asarray(cleaned_text_to_sequence(ph, version), np.int32)
            self._frames.append(n_frames)
        self.reads = {"native": 0, "python": 0}

    def __len__(self):
        return len(self.names)

    def lengths(self) -> list[int]:
        return list(self._frames)

    def _load_batch_files(self, names: list[str]) -> tuple[list, list]:
        """The batch's waveforms and SSL features: through the native reader
        when it is built and reads every file, else with Python (JAX
        data.py:222-233). `reads` counts the batches of each path."""
        wav_paths = [os.path.join(self.exp_dir, "5-wav32k", n) for n in names]
        ssl_paths = [os.path.join(self.exp_dir, "4-cnhubert", f"{n}.npy") for n in names]
        if native.load() is not None:
            max_len = max(os.path.getsize(p) // 2 for p in wav_paths) + 8  # pcm16 bound
            res = native.wav_batch(wav_paths, max_len)
            ssl_cols = np.load(ssl_paths[0], mmap_mode="r").shape[-1]
            max_rows = max(os.path.getsize(p) for p in ssl_paths) // (2 * ssl_cols) + 4
            res2 = native.npy_batch(ssl_paths, max_rows, ssl_cols)
            if res is not None and res2 is not None and not res[3].any() and not res2[2].any():
                out, lengths, _, _ = res
                ssl_out, rows, _ = res2
                self.reads["native"] += 1
                return ([out[i, : lengths[i]] for i in range(len(names))],
                        [ssl_out[i, : rows[i]] for i in range(len(names))])
        self.reads["python"] += 1
        return ([load_wav(p)[0] for p in wav_paths], [np.load(p).astype(np.float32) for p in ssl_paths])

    def _spec(self, wav: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return spectrogram(torch.from_numpy(np.ascontiguousarray(wav))[None], self.mel_cfg)[0].T.numpy()

    def collate(self, idxs: Sequence[int], buckets=(128, 256, 512, 1024, 1600)) -> dict:
        names = [self.names[i] for i in idxs]
        wavs, ssls = self._load_batch_files(names)
        hop = self.mel_cfg.hop_size
        t_spec = _next_bucket(max(len(w) // hop for w in wavs), buckets)
        t_ssl = t_spec * 2  # 50 Hz SSL against the 25 Hz latent at hop 640
        tx = max(len(self.phones[n]) for n in names)
        b = len(names)
        spec_arr = np.zeros((b, t_spec, self.mel_cfg.n_fft // 2 + 1), np.float32)
        wav_arr = np.zeros((b, t_spec * hop, 1), np.float32)
        ssl_arr = np.zeros((b, t_ssl, ssls[0].shape[-1]), np.float32)
        text_arr = np.zeros((b, tx), np.int32)
        spec_lens = np.zeros((b,), np.int32)
        text_lens = np.zeros((b,), np.int32)
        sv_list = []
        for i, (name, wav, ssl) in enumerate(zip(names, wavs, ssls)):
            n_frames = min(len(wav) // hop, t_spec)
            wav = wav[: n_frames * hop]
            spec = self._spec(wav)
            spec_arr[i, : spec.shape[0]] = spec
            wav_arr[i, : len(wav), 0] = wav
            m = min(len(ssl), t_ssl)
            ssl_arr[i, :m] = ssl[:m]
            ph = self.phones[name]
            text_arr[i, : len(ph)] = ph
            spec_lens[i] = n_frames
            text_lens[i] = len(ph)
            sv_path = os.path.join(self.exp_dir, "7-sv_cn", f"{name}.npy")
            if os.path.exists(sv_path):
                sv_list.append(np.load(sv_path).astype(np.float32))
        batch = {"ssl": ssl_arr, "spec": spec_arr, "spec_lengths": spec_lens, "wav": wav_arr, "text": text_arr,
                 "text_lengths": text_lens}
        if len(sv_list) == len(names):
            batch["sv_emb"] = np.stack(sv_list)
        return batch


class V3Dataset(S2Dataset):
    """v3/v4 CFM training data (ref TextAudioSpeakerLoaderV3/V4,
    data_utils.py:285/:523; JAX data.py:290): the 32 kHz linear spectrogram
    for the timbre, the normalized target mel from the wav resampled to the
    version's rate (MEL_V3, 24 kHz/1024/256; MEL_V4, 32 kHz/1280/320), SSL
    features (t_ssl = 2 * t_spec) and phoneme ids; spec and mel frames each
    padded to a bucket."""

    def __init__(self, exp_dir: str, *, version: str = "v3", mel_cfg: MelConfig = MelConfig(),
                 mel_cfg_v: Optional[MelConfig] = None, **kw):
        super().__init__(exp_dir, version=version, mel_cfg=mel_cfg, **kw)
        self.mel_cfg_v = mel_cfg_v or (MEL_V4 if version == "v4" else MEL_V3)

    def collate(self, idxs: Sequence[int], buckets=(128, 256, 512, 1024, 1600)) -> dict:
        names = [self.names[i] for i in idxs]
        wavs, ssls = self._load_batch_files(names)
        hop = self.mel_cfg.hop_size
        mcfg = self.mel_cfg_v
        sr, sr_mel = self.mel_cfg.sampling_rate, mcfg.sampling_rate
        t_spec = _next_bucket(max(len(w) // hop for w in wavs), buckets)
        t_ssl = t_spec * 2
        t_mel = _next_bucket(max((len(w) * sr_mel // sr) // mcfg.hop_size for w in wavs), buckets)
        tx = max(len(self.phones[n]) for n in names)
        b = len(names)
        spec_arr = np.zeros((b, t_spec, self.mel_cfg.n_fft // 2 + 1), np.float32)
        mel_arr = np.zeros((b, t_mel, mcfg.num_mels), np.float32)
        ssl_arr = np.zeros((b, t_ssl, ssls[0].shape[-1]), np.float32)
        text_arr = np.zeros((b, tx), np.int32)
        spec_lens, mel_lens, text_lens = (np.zeros((b,), np.int32) for _ in range(3))
        for i, (name, wav, ssl) in enumerate(zip(names, wavs, ssls)):
            n_frames = min(len(wav) // hop, t_spec)
            wav = wav[: n_frames * hop]
            spec = self._spec(wav)
            spec_arr[i, : spec.shape[0]] = spec
            wav_v = resample(np.asarray(wav, np.float32), sr, sr_mel)
            with torch.no_grad():
                mel = norm_spec(mel_spectrogram(torch.from_numpy(wav_v)[None], mcfg))[0].T.numpy()  # (Tm, mel)
            m = min(mel.shape[0], t_mel)
            mel_arr[i, :m] = mel[:m]
            mel_lens[i] = m
            k = min(len(ssl), t_ssl)
            ssl_arr[i, :k] = ssl[:k]
            ph = self.phones[name]
            text_arr[i, : len(ph)] = ph
            spec_lens[i] = n_frames
            text_lens[i] = len(ph)
        return {"ssl": ssl_arr, "spec": spec_arr, "spec_lengths": spec_lens, "mel": mel_arr, "mel_lengths": mel_lens,
                "text": text_arr, "text_lengths": text_lens}


def batch_to(batch: dict, device) -> dict:
    """A collate's numpy arrays -> tensors on `device`: integers int64,
    floats float32."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t.to(device, torch.float32 if t.is_floating_point() else torch.long)
    return out


def data_iterator(dataset, sampler: BucketSampler, epoch: int, *, prefetch: int = 2) -> Iterator[dict]:
    """One epoch's batches, collated `prefetch` ahead on a background thread
    so file reads overlap the device's work."""
    batches = sampler.epoch_batches(epoch)
    if prefetch <= 0 or len(batches) <= 1:
        for idxs in batches:
            yield dataset.collate(idxs)
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        try:
            for idxs in batches:
                if stop.is_set():
                    return
                q.put(dataset.collate(idxs))
            q.put(None)
        except Exception as e:  # handed to the consumer, which raises it
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():  # unblock a worker waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.05)
