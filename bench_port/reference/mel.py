"""Spectrograms (a frozen copy of gpt_sovits_tpu_torch/dsp/mel.py, itself a port of gpt_sovits_tpu/dsp/mel.py).

Conventions of the reference's `spectrogram_torch` / `spec_to_mel_torch` /
`mel_spectrogram_torch` (mel_processing.py:40-144): reflect-pad
(n_fft - hop)/2 on each side, center=False STFT, periodic hann window,
magnitude sqrt(re^2 + im^2 + 1e-8), librosa's slaney mel filterbank
(htk=False, slaney norm), log(clamp(x, 1e-5)). The JAX package's matmul-DFT
is a TPU device; here `torch.stft` computes the same frames.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.common import MelConfig, at_least_f32


def spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, L) waveform in [-1,1] -> (B, n_fft//2+1, T) linear magnitude."""
    pad = int((cfg.n_fft - cfg.hop_size) / 2)
    y = F.pad(at_least_f32(y)[:, None, :], (pad, pad), mode="reflect")[:, 0]
    window = torch.hann_window(cfg.win_size, periodic=True, dtype=y.dtype, device=y.device)
    z = torch.stft(
        y, cfg.n_fft, hop_length=cfg.hop_size, win_length=cfg.win_size, window=window,
        center=False, return_complex=True,
    )
    return torch.sqrt(z.real * z.real + z.imag * z.imag + 1e-8)


def _hz_to_mel_slaney(freq) -> np.ndarray:
    """Slaney mel scale (librosa htk=False): linear below 1 kHz, log above."""
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / f_sp
    return np.where(freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(mels) -> np.ndarray:
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = np.asarray(mels, dtype=np.float64)
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)


@functools.lru_cache(maxsize=32)
def mel_filterbank(sampling_rate: int, n_fft: int, num_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (num_mels, n_fft//2+1),
    as librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) builds it."""
    if fmax is None:
        fmax = float(sampling_rate) / 2
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0, float(sampling_rate) / 2, n_bins, dtype=np.float64)
    mel_pts = np.linspace(_hz_to_mel_slaney(np.array(fmin)), _hz_to_mel_slaney(np.array(fmax)), num_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels]))[:, None]  # equal area per band
    return weights.astype(np.float32)


def spec_to_mel(spec: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, bins, T) linear magnitude -> (B, num_mels, T) log-mel."""
    fb = torch.from_numpy(mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax))
    spec = at_least_f32(spec)
    mel = torch.einsum("mf,bft->bmt", fb.to(spec.device, spec.dtype), spec)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, L) waveform -> (B, num_mels, T) log-mel."""
    return spec_to_mel(spectrogram(y, cfg), cfg)


# v3/v4 mel normalization: the spec range [-12, 2] maps to [-1, 1]
# (reference TTS_infer_pack/TTS.py norm_spec / denorm_spec)
_SPEC_MIN = -12.0
_SPEC_MAX = 2.0


def norm_spec(x):
    return (x - _SPEC_MIN) / (_SPEC_MAX - _SPEC_MIN) * 2.0 - 1.0


def denorm_spec(x):
    return (x + 1.0) / 2.0 * (_SPEC_MAX - _SPEC_MIN) + _SPEC_MIN
