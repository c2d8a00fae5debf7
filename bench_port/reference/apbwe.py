"""AP-BWE, 24 kHz -> 48 kHz bandwidth extension (the reference project's
tools/AP_BWE_main: models/model.py `APNet_BWE_Model` and `ConvNeXtBlock`,
datasets/dataset.py `amp_pha_stft` / `amp_pha_istft`, and tools/audio_sr.py
`AP_BWE`), written out in plain PyTorch for the benchmark's reference. It
imports nothing of the program.

The published description, and where this copy departs from it:
  * the waveform is resampled to the high rate; a centred STFT (n_fft 1024,
    hop 240, a periodic Hann window of 1024, reflect padding) gives the
    narrow band's log amplitude log(|z| + 1e-4) and phase angle(z);
  * two streams of 512 channels, amplitude and phase: each a 7-tap input
    convolution from the 513 bins and a LayerNorm (eps 1e-6); then 8
    layers, in each of which the amplitude stream adds the phase stream,
    the phase stream adds the new amplitude stream, and each goes through
    its own ConvNeXt block (a depthwise 7-tap convolution, LayerNorm, a
    Linear to 3 x 512, the exact GELU, a Linear back, a per-channel layer
    scale, the residual); a LayerNorm at the end of each;
  * the wide band's log amplitude is the narrow band's plus a Linear of the
    amplitude stream; its phase the atan2 of two Linears (imaginary, real)
    of the phase stream; the waveform the iSTFT of exp(amplitude) at that
    phase (window-square normalised overlap-add, centred);
  * departures: the resampling to 48 kHz is scipy's polyphase filter on the
    host in float64 (`resample_poly`), where tools/audio_sr.py calls
    torchaudio's windowed-sinc resampler on the device; the layer scale is
    whatever the weights give it (the published initial value is 1 / 8).

Parameter names are the published checkpoint's (`conv_pre_mag`,
`convnext_pha.{i}.pwconv1`, `linear_post_pha_i`, ...).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port.reference.voice import resample


def amp_pha_stft(audio: torch.Tensor, c: dict):
    """(B, L) -> log amplitude and phase, each (B, n_fft // 2 + 1, frames)."""
    window = torch.hann_window(c["win_size"], dtype=torch.float32, device=audio.device)
    z = torch.stft(audio, c["n_fft"], hop_length=c["hop_size"], win_length=c["win_size"], window=window,
                   center=True, pad_mode="reflect", normalized=False, return_complex=True)
    return torch.log(torch.abs(z) + 1e-4), torch.angle(z)


def amp_pha_istft(log_amp: torch.Tensor, pha: torch.Tensor, c: dict) -> torch.Tensor:
    amp = torch.exp(log_amp)
    z = torch.complex(amp * torch.cos(pha), amp * torch.sin(pha))
    window = torch.hann_window(c["win_size"], dtype=torch.float32, device=log_amp.device)
    return torch.istft(z, c["n_fft"], hop_length=c["hop_size"], win_length=c["win_size"], window=window, center=True)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, dim * 3)
        self.pwconv2 = nn.Linear(dim * 3, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        h = self.norm(self.dwconv(x).transpose(1, 2))
        h = self.gamma * self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + h.transpose(1, 2)


class APNetBWE(nn.Module):
    """`c` a configuration file's "apbwe" object: n_fft, hop_size,
    win_size, channels, layers, hr_sampling_rate."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        bins, ch = c["n_fft"] // 2 + 1, c["channels"]
        self.conv_pre_mag = nn.Conv1d(bins, ch, 7, padding=3)
        self.norm_pre_mag = nn.LayerNorm(ch, eps=1e-6)
        self.conv_pre_pha = nn.Conv1d(bins, ch, 7, padding=3)
        self.norm_pre_pha = nn.LayerNorm(ch, eps=1e-6)
        self.convnext_mag = nn.ModuleList(ConvNeXtBlock(ch) for _ in range(c["layers"]))
        self.convnext_pha = nn.ModuleList(ConvNeXtBlock(ch) for _ in range(c["layers"]))
        self.norm_post_mag = nn.LayerNorm(ch, eps=1e-6)
        self.norm_post_pha = nn.LayerNorm(ch, eps=1e-6)
        self.linear_post_mag = nn.Linear(ch, bins)
        self.linear_post_pha_r = nn.Linear(ch, bins)
        self.linear_post_pha_i = nn.Linear(ch, bins)

    def forward(self, mag_nb, pha_nb):
        """(B, bins, frames) narrow band -> the wide band's log amplitude and
        phase, same shapes."""
        x_mag = self.norm_pre_mag(self.conv_pre_mag(mag_nb).transpose(1, 2)).transpose(1, 2)
        x_pha = self.norm_pre_pha(self.conv_pre_pha(pha_nb).transpose(1, 2)).transpose(1, 2)
        for block_mag, block_pha in zip(self.convnext_mag, self.convnext_pha):
            x_mag = x_mag + x_pha
            x_pha = x_pha + x_mag
            x_mag = block_mag(x_mag)
            x_pha = block_pha(x_pha)
        x_mag = self.norm_post_mag(x_mag.transpose(1, 2))
        mag_wb = mag_nb + self.linear_post_mag(x_mag).transpose(1, 2)
        x_pha = self.norm_post_pha(x_pha.transpose(1, 2))
        pha_wb = torch.atan2(self.linear_post_pha_i(x_pha), self.linear_post_pha_r(x_pha)).transpose(1, 2)
        return mag_wb, pha_wb

    @torch.no_grad()
    def super_resolve(self, wav: np.ndarray, orig_sr: int) -> torch.Tensor:
        """One segment (L,) at orig_sr -> (L',) float32 at hr_sampling_rate,
        on the model's device."""
        c = self.c
        dev = next(self.parameters()).device
        up = torch.from_numpy(resample(wav, orig_sr, c["hr_sampling_rate"])[None]).to(dev)
        mag, pha = amp_pha_stft(up, c)
        return amp_pha_istft(*self(mag, pha), c)[0]
