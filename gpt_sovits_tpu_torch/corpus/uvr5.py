"""Vocal separation router of the UVR5 family (port of
gpt_sovits_tpu/corpus/uvr5.py).

Given a model file, `separate_vocals` picks the family as the reference
webui does (tools/uvr5/webui.py:45): RoFormer by file name
(corpus/roformer.py), MDX-Net for an `.onnx` (corpus/mdx.py), else a VR net
(corpus/vr.py). Without a model file it runs the weights-free HPSS split
(numpy/scipy, on the host), as the JAX package does; it is never chosen
after a model fails.
"""

from __future__ import annotations

import os

import numpy as np


def separate_vocals(wav: np.ndarray, sr: int, *, backend: str = "auto", model_path: str | None = None,
                    config_path: str | None = None, agg: int = 10, device=None) -> tuple[np.ndarray, np.ndarray]:
    """-> (vocals, accompaniment) at the input rate. backend:
    auto|roformer|vr|mdx|hpss; the models run on `device` (the card unless
    "cpu")."""
    if model_path and backend in ("auto", "roformer", "vr", "mdx"):
        name = os.path.basename(model_path).lower()
        is_rof = backend == "roformer" or any(
            k in name for k in ("bs_roformer", "bsroformer", "mel_band_roformer", "melbandroformer"))
        if is_rof:
            from gpt_sovits_tpu_torch.corpus.roformer import separate as rof_separate

            return rof_separate(wav, sr, model_path, config_path=config_path, device=device)
        if backend == "mdx" or name.endswith(".onnx"):
            from gpt_sovits_tpu_torch.corpus.mdx import separate as mdx_separate

            return mdx_separate(wav, sr, model_path, device=device)
        from gpt_sovits_tpu_torch.corpus.vr import separate as vr_separate

        return vr_separate(wav, sr, model_path, agg=agg, device=device)
    if backend not in ("auto", "hpss"):
        raise ValueError(f"backend {backend!r} needs model_path")
    return hpss_vocal_emphasis(wav, sr)


def hpss_vocal_emphasis(wav: np.ndarray, sr: int, *, n_fft: int = 2048, hop: int = 512, kernel: int = 17,
                        power: float = 2.0) -> tuple[np.ndarray, np.ndarray]:
    """Harmonic/percussive median-filter separation (Fitzgerald 2010):
    vocals ride mostly in the harmonic part. A weights-free pre-clean.
    (L,) or (S, L): a multichannel input is split channel by channel (the
    JAX package's version takes mono only and fails on a stereo file)."""
    from scipy.ndimage import median_filter

    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        parts = [hpss_vocal_emphasis(c, sr, n_fft=n_fft, hop=hop, kernel=kernel, power=power) for c in wav]
        return np.stack([v for v, _ in parts]), np.stack([o for _, o in parts])
    win = np.hanning(n_fft + 1)[:-1]
    pad = n_fft // 2
    x = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(x[idx] * win, axis=-1)  # (T, F)
    mag = np.abs(spec)
    hp = median_filter(mag, size=(kernel, 1), mode="nearest") ** power  # smooth over time: harmonic
    pp = median_filter(mag, size=(1, kernel), mode="nearest") ** power  # smooth over frequency: percussive
    mask_h = hp / np.maximum(hp + pp, 1e-9)

    def resynth(masked):
        frames = np.fft.irfft(masked, n=n_fft, axis=-1) * win
        out = np.zeros(len(x), np.float32)
        wsum = np.zeros(len(x), np.float32)
        for i in range(n_frames):
            s = i * hop
            out[s: s + n_fft] += frames[i]
            wsum[s: s + n_fft] += win * win
        return (out / np.maximum(wsum, 1e-8))[pad: pad + len(wav)].astype(np.float32)

    return resynth(spec * mask_h), resynth(spec * (1.0 - mask_h))
