"""RMS-threshold silence slicer for corpus preparation (a copy of
gpt_sovits_tpu/dsp/slicer.py: numpy only).

Counterpart of tools/slicer2.py:38 (`Slicer`): frame-level RMS, silence-run
detection with min-length / min-interval / max-silence-kept rules, cutting
at the quietest frame of each silent run.
"""

from __future__ import annotations

import numpy as np


def frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centered RMS per frame (librosa.feature.rms convention)."""
    y = np.asarray(y, dtype=np.float32)
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad))
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    frames = yp[idx]
    return np.sqrt(np.mean(frames**2, axis=-1))


class Slicer:
    def __init__(
        self,
        sr: int,
        threshold: float = -40.0,
        min_length: int = 5000,  # ms
        min_interval: int = 300,  # ms
        hop_size: int = 20,  # ms
        max_sil_kept: int = 5000,  # ms
    ):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("need min_length >= min_interval >= hop_size")
        if not max_sil_kept >= hop_size:
            raise ValueError("need max_sil_kept >= hop_size")
        min_interval_samp = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samp), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samp / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def slice(self, waveform: np.ndarray) -> list[np.ndarray]:
        samples = waveform.mean(axis=0) if waveform.ndim > 1 else waveform
        if samples.shape[0] <= self.min_length:
            return [waveform]
        rms = frame_rms(samples, self.win_size, self.hop_size)

        sil_tags: list[tuple[int, int]] = []
        silence_start: int | None = None
        clip_start = 0
        msk = self.max_sil_kept
        for i, r in enumerate(rms):
            if r < self.threshold:
                if silence_start is None:
                    silence_start = i
                continue
            if silence_start is None:
                continue
            is_leading = silence_start == 0 and i > msk
            need_mid = (i - silence_start >= self.min_interval) and (i - clip_start >= self.min_length)
            if not is_leading and not need_mid:
                silence_start = None
                continue
            run = i - silence_start
            if run <= msk:
                pos = int(rms[silence_start : i + 1].argmin()) + silence_start
                sil_tags.append((0, pos) if silence_start == 0 else (pos, pos))
                clip_start = pos
            else:
                pos_l = int(rms[silence_start : silence_start + msk + 1].argmin()) + silence_start
                pos_r = int(rms[i - msk : i + 1].argmin()) + i - msk
                if run <= 2 * msk:
                    pos = int(rms[i - msk : silence_start + msk + 1].argmin()) + i - msk
                    if silence_start == 0:
                        sil_tags.append((0, pos_r))
                        clip_start = pos_r
                    else:
                        sil_tags.append((min(pos_l, pos), max(pos_r, pos)))
                        clip_start = max(pos_r, pos)
                else:
                    sil_tags.append((0, pos_r) if silence_start == 0 else (pos_l, pos_r))
                    clip_start = pos_r
            silence_start = None

        total = len(rms)
        if silence_start is not None and total - silence_start >= self.min_interval:
            sil_end = min(total, silence_start + msk)
            pos = int(rms[silence_start:sil_end].argmin()) + silence_start
            sil_tags.append((pos, total + 1))

        if not sil_tags:
            return [waveform]
        chunks = []
        if sil_tags[0][0] > 0:
            chunks.append(self._cut(waveform, 0, sil_tags[0][0]))
        for a, b in zip(sil_tags, sil_tags[1:]):
            chunks.append(self._cut(waveform, a[1], b[0]))
        if sil_tags[-1][1] < total:
            chunks.append(self._cut(waveform, sil_tags[-1][1], total))
        return [c for c in chunks if c.shape[-1] > 0]

    def _cut(self, waveform, begin, end):
        h = self.hop_size
        if waveform.ndim > 1:
            return waveform[:, begin * h : min(waveform.shape[1], end * h)]
        return waveform[begin * h : min(waveform.shape[0], end * h)]
