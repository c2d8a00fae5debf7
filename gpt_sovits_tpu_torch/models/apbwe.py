"""AP-BWE audio super-resolution, 24 kHz -> 48 kHz bandwidth extension
(port of gpt_sovits_tpu/models/apbwe.py; reference tools/AP_BWE_main/
models/model.py `APNet_BWE_Model` and tools/audio_sr.py).

Dual amplitude / phase ConvNeXt streams over a center=True STFT and an
overlap-add iSTFT, applied to each v3 segment after the BigVGAN vocoder when
super-resolution is asked for. Defaults are the published 24k -> 48k
recipe (n_fft 1024, hop 240, 8 layers of 512 channels). Parameter names are
the reference's (`conv_pre_mag`, `convnext_mag.{i}.dwconv`, ...,
`linear_post_pha_i`). No Pallas kernel is involved: the STFT pair is
`torch.stft` / `torch.istft`, the layers are cuDNN convolutions and plain
PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gpt_sovits_tpu_torch.dsp.audio_io import resample
from gpt_sovits_tpu_torch.utils.metrics import recorder

_REC = recorder()
_RESAMPLE, _LAUNCH, _SAMPLES_OUT = (_REC.intern(n) for n in ("apbwe.resample", "apbwe.launch", "apbwe.samples_out"))


@dataclass(frozen=True)
class APBWEConfig:
    n_fft: int = 1024
    hop_size: int = 240
    win_size: int = 1024
    channels: int = 512
    layers: int = 8
    hr_sampling_rate: int = 48000


def amp_pha_stft(audio: torch.Tensor, n_fft: int, hop: int, win: int):
    """(B, L) -> (log amplitude, phase), each (B, n_fft // 2 + 1, frames):
    center=True with reflect padding, periodic Hann window."""
    window = torch.hann_window(win, dtype=torch.float32, device=audio.device)
    z = torch.stft(audio.float(), n_fft, hop_length=hop, win_length=win, window=window, center=True,
                   pad_mode="reflect", return_complex=True)
    return torch.log(torch.abs(z) + 1e-4), torch.angle(z)


def amp_pha_istft(log_amp: torch.Tensor, pha: torch.Tensor, n_fft: int, hop: int, win: int):
    """(B, bins, frames) log amplitude and phase -> (B, hop * (frames - 1))
    waveform, windowed overlap-add normalized by the window's square sum
    (torch.istft, center=True)."""
    window = torch.hann_window(win, dtype=torch.float32, device=log_amp.device)
    z = torch.polar(torch.exp(log_amp.float()), pha.float())
    return torch.istft(z, n_fft, hop_length=hop, win_length=win, window=window, center=True)


class ConvNeXtBlock(nn.Module):
    """(B, C, T): depthwise conv 7, LayerNorm (eps 1e-6), x3 pointwise MLP
    with exact-erf GELU, layer scale, residual."""

    def __init__(self, dim: int, layer_scale_init: float):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, dim * 3)
        self.pwconv2 = nn.Linear(dim * 3, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))

    def forward(self, x):
        h = self.norm(self.dwconv(x).transpose(1, 2))
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + (self.gamma * h).transpose(1, 2)


class APNetBWE(nn.Module):
    def __init__(self, cfg: APBWEConfig = APBWEConfig()):
        super().__init__()
        self.cfg = c = cfg
        bins = c.n_fft // 2 + 1
        for s in ("mag", "pha"):
            setattr(self, f"conv_pre_{s}", nn.Conv1d(bins, c.channels, 7, padding=3))
            setattr(self, f"norm_pre_{s}", nn.LayerNorm(c.channels, eps=1e-6))
            setattr(self, f"convnext_{s}", nn.ModuleList(ConvNeXtBlock(c.channels, 1.0 / c.layers)
                                                         for _ in range(c.layers)))
            setattr(self, f"norm_post_{s}", nn.LayerNorm(c.channels, eps=1e-6))
        self.linear_post_mag = nn.Linear(c.channels, bins)
        self.linear_post_pha_r = nn.Linear(c.channels, bins)
        self.linear_post_pha_i = nn.Linear(c.channels, bins)

    def forward(self, mag_nb, pha_nb):
        """(B, bins, T) narrow-band log amplitude and phase -> the wide-band
        pair, same shapes."""
        x_mag = self.norm_pre_mag(self.conv_pre_mag(mag_nb).transpose(1, 2)).transpose(1, 2)
        x_pha = self.norm_pre_pha(self.conv_pre_pha(pha_nb).transpose(1, 2)).transpose(1, 2)
        for blk_mag, blk_pha in zip(self.convnext_mag, self.convnext_pha):
            x_mag = x_mag + x_pha
            x_pha = x_pha + x_mag
            x_mag = blk_mag(x_mag)
            x_pha = blk_pha(x_pha)
        x_mag = self.norm_post_mag(x_mag.transpose(1, 2))
        mag_wb = mag_nb + self.linear_post_mag(x_mag).transpose(1, 2)
        x_pha = self.norm_post_pha(x_pha.transpose(1, 2))
        pha_wb = torch.atan2(self.linear_post_pha_i(x_pha), self.linear_post_pha_r(x_pha)).transpose(1, 2)
        return mag_wb, pha_wb


@torch.no_grad()
def super_resolve(model: APNetBWE, audio, orig_sr: int):
    """(B, L) waveform at orig_sr (numpy or tensor) -> ((B, L') f32 tensor
    at hr_sampling_rate on the model's device, hr_sampling_rate)
    (tools/audio_sr.py:40): host resampling to the high rate, STFT, the
    model, iSTFT.

    Recorded (utils/metrics.py): an `apbwe.resample` span (the host
    resampling), an `apbwe.launch` span (the upload, STFT, model and iSTFT
    issued to the device; no sync) and the `apbwe.samples_out` counter (the
    output's samples, all rows)."""
    c = model.cfg
    p = next(model.parameters())
    span = _REC.begin(_RESAMPLE)
    audio = audio.detach().cpu().numpy() if isinstance(audio, torch.Tensor) else np.asarray(audio)
    up = np.stack([resample(np.asarray(a, np.float32), orig_sr, c.hr_sampling_rate) for a in audio])
    _REC.end(span)
    span = _REC.begin(_LAUNCH)
    mag, pha = amp_pha_stft(torch.from_numpy(up).to(p.device), c.n_fft, c.hop_size, c.win_size)
    mag_wb, pha_wb = model(mag.to(p.dtype), pha.to(p.dtype))
    out = amp_pha_istft(mag_wb, pha_wb, c.n_fft, c.hop_size, c.win_size)
    _REC.end(span)
    _REC.count(_SAMPLES_OUT, out.numel())
    return out, c.hr_sampling_rate
