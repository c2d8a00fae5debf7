"""Denoising for corpus preparation (port of gpt_sovits_tpu/corpus/denoise.py).

Counterpart of tools/cmd-denoise.py (modelscope's FRCRN pipeline). Tiers:
  1. the port's FRCRN (models/frcrn.py) on the card when a checkpoint is
     given or found at $GSVT_FRCRN_CKPT;
  2. the modelscope pipeline itself when installed (`denoise_modelscope`,
     imported only there);
  3. `spectral_gate`, a weights-free noise-profile spectral subtraction
     (numpy, on the host), chosen only when no checkpoint is given.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def spectral_gate(wav: np.ndarray, sr: int, *, n_fft: int = 1024, hop: int = 256, noise_frames: int = 20,
                  reduction_db: float = 18.0, smoothing: int = 2) -> np.ndarray:
    """Spectral gating: a noise floor from the quietest frames; bins below
    floor + threshold attenuated. Pure numpy."""
    wav = np.asarray(wav, np.float32)
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    pad = n_fft // 2
    x = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(x[idx] * win, axis=-1)
    mag = np.abs(spec)

    # the noise profile from the lowest-energy frames (speech pauses)
    quiet = np.argsort(mag.sum(axis=1))[: max(noise_frames, 1)]
    noise_floor = mag[quiet].mean(axis=0, keepdims=True)

    # over-subtraction with a gain floor (classic spectral subtraction)
    alpha = 1.5
    floor_gain = 10 ** (-reduction_db / 20.0)
    gain = np.clip(1.0 - alpha * noise_floor / np.maximum(mag, 1e-9), floor_gain, 1.0)
    if smoothing > 0:  # temporal smoothing of the gain against musical noise
        kernel = np.ones(2 * smoothing + 1) / (2 * smoothing + 1)
        gain = np.apply_along_axis(lambda g: np.convolve(g, kernel, mode="same"), 0, gain)

    frames_dn = np.fft.irfft(spec * gain, n=n_fft, axis=-1) * win
    out = np.zeros(len(x), np.float32)
    wsum = np.zeros(len(x), np.float32)
    for i in range(n_frames):
        s = i * hop
        out[s: s + n_fft] += frames_dn[i]
        wsum[s: s + n_fft] += win * win
    out = out / np.maximum(wsum, 1e-8)
    return out[pad: pad + len(wav)]


_FRCRN_CACHE: dict = {}


def denoise_frcrn(wav: np.ndarray, sr: int, ckpt_path: str, device=None) -> np.ndarray:
    """FRCRN on `device` (the card unless "cpu"): resampled to the model's
    16 kHz, the complex-mask network, resampled back."""
    from gpt_sovits_tpu_torch.dsp.audio_io import resample
    from gpt_sovits_tpu_torch.models.frcrn import load_frcrn

    key = (ckpt_path, str(device))
    if key not in _FRCRN_CACHE:
        _FRCRN_CACHE.clear()  # one model at a time: corpus tools are batch jobs
        _FRCRN_CACHE[key] = load_frcrn(ckpt_path, device=device)
    model = _FRCRN_CACHE[key]
    wav = np.asarray(wav, np.float32)
    x = resample(wav, sr, 16000) if sr != 16000 else wav
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(x))[None].to(next(model.parameters()).device))[0]
    out = out[0].cpu().numpy()
    return resample(out, 16000, sr)[: len(wav)] if sr != 16000 else out


def denoise(wav: np.ndarray, sr: int, ckpt_path: Optional[str] = None, device=None) -> np.ndarray:
    """FRCRN when a checkpoint is given (or found at $GSVT_FRCRN_CKPT), the
    spectral gate otherwise."""
    ckpt_path = ckpt_path or os.environ.get("GSVT_FRCRN_CKPT")
    if ckpt_path and os.path.exists(ckpt_path):
        return denoise_frcrn(wav, sr, ckpt_path, device)
    return spectral_gate(wav, sr)


def denoise_modelscope(wav_path: str, out_path: str) -> str:
    """FRCRN through modelscope when installed (tools/cmd-denoise.py)."""
    try:
        from modelscope.pipelines import pipeline
    except ImportError as e:
        raise ImportError("modelscope is not installed; use spectral_gate or install modelscope") from e
    p = pipeline("acoustic-noise-suppression", model="damo/speech_frcrn_ans_cirm_16k")
    p(wav_path, output_path=out_path)
    return out_path
