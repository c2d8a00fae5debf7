"""SOLA crossfade stitching (a frozen copy of gpt_sovits_tpu_torch/dsp/sola.py,
for the benchmark's reference; itself a copy of gpt_sovits_tpu/dsp/sola.py; reference
TTS.sola_algorithm, TTS_infer_pack/TTS.py:1611-1635): adjacent fragments
are aligned by cross-correlation over an overlap window and hann-crossfaded
at the best lag."""

from __future__ import annotations

import numpy as np


def sola_stitch(fragments: list[np.ndarray], overlap_len: int) -> np.ndarray:
    """Stitch 1-D float fragments, each overlapping the next by about
    `overlap_len` samples."""
    frags = [np.asarray(f, dtype=np.float32) for f in fragments]
    if len(frags) == 1:
        return frags[0]
    for i in range(len(frags) - 1):
        f1, f2 = frags[i], frags[i + 1]
        w1 = f1[-overlap_len:]
        w2 = f2[:overlap_len]
        # correlation of w1 against w2 at each lag (the reference's
        # conv1d(w1, w2, padding=K//2)); the argmax is the best alignment
        corr = np.correlate(np.pad(w1, (overlap_len // 2, overlap_len // 2)), w2, mode="valid")[:-1]
        idx = int(np.argmax(corr))
        cut = overlap_len - idx  # idx < overlap_len, so cut >= 1
        frags[i] = f1[:-cut]
        f2_ = f2[idx:].copy()
        # periodic hann(2*cut): the first half rises, the second falls
        n = np.arange(2 * cut)
        window = 0.5 - 0.5 * np.cos(2 * np.pi * n / (2 * cut))
        f2_[:cut] = window[:cut] * f2_[:cut] + window[cut:] * f1[-cut:]
        frags[i + 1] = f2_
    return np.concatenate(frags, axis=0)
