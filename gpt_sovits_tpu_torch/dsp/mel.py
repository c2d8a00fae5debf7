"""Linear spectrogram (port of gpt_sovits_tpu/dsp/mel.py `spectrogram`).

Conventions of the reference's `spectrogram_torch` (mel_processing.py:40):
reflect-pad (n_fft - hop)/2 on each side, center=False STFT, periodic hann
window, magnitude sqrt(re^2 + im^2 + 1e-8). The JAX package's matmul-DFT is
a TPU device; here `torch.stft` computes the same frames.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpt_sovits_tpu_torch.utils.config import MelConfig


def spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, L) waveform in [-1,1] -> (B, n_fft//2+1, T) linear magnitude."""
    pad = int((cfg.n_fft - cfg.hop_size) / 2)
    y = F.pad(y.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    window = torch.hann_window(cfg.win_size, periodic=True, dtype=torch.float32, device=y.device)
    z = torch.stft(
        y, cfg.n_fft, hop_length=cfg.hop_size, win_length=cfg.win_size, window=window,
        center=False, return_complex=True,
    )
    return torch.sqrt(z.real * z.real + z.imag * z.imag + 1e-8)
