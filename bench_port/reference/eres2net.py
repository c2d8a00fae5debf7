"""ERes2NetV2 speaker-verification embedder for the v2Pro family and its
Kaldi fbank front end (a frozen copy of gpt_sovits_tpu_torch/models/eres2net.py,
for the benchmark's reference).

`kaldi_fbank` (80-bin kaldi log-mel, dither 0) feeds `ERes2NetV2`, whose
serving entry (reference ERes2NetV2.py:240 forward3) returns the bottom-up
fused map flattened over (C, F) and averaged over time: a 20480-d embedding
at the default width. Inference only: BatchNorm runs on its running
statistics. Images are NCHW with H = frequency, W = time, as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn


def _povey_window(n: int) -> np.ndarray:
    a = 2 * np.pi / (n - 1)
    return (0.5 - 0.5 * np.cos(a * np.arange(n))) ** 0.85


def _kaldi_mel_banks(num_bins: int, n_fft: int, sr: int) -> np.ndarray:
    """HTK mel scale, triangular, no area normalization, nyquist bin dropped."""

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    mel_low, mel_high = mel(20.0), mel(sr / 2.0)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    fft_mel = mel(np.arange(n_fft // 2 + 1) * sr / n_fft)
    banks = np.zeros((num_bins, n_fft // 2 + 1), dtype=np.float64)
    for m in range(num_bins):
        left = mel_low + m * mel_delta
        center = mel_low + (m + 1) * mel_delta
        right = mel_low + (m + 2) * mel_delta
        up = (fft_mel - left) / (center - left)
        down = (right - fft_mel) / (right - center)
        banks[m] = np.clip(np.minimum(up, down), 0.0, None)
    banks[:, -1] = 0.0
    return banks.astype(np.float32)


def kaldi_fbank(wav: torch.Tensor, *, num_mel_bins: int = 80, sample_frequency: int = 16000,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0, preemphasis: float = 0.97) -> torch.Tensor:
    """(B, L) float wav -> (B, T, num_mel_bins) kaldi log-mel (snip_edges,
    DC removal, preemphasis, povey window; the reference feeds the [-1, 1]
    waveform unscaled)."""
    frame_len = int(sample_frequency * frame_length_ms / 1000)
    frame_shift = int(sample_frequency * frame_shift_ms / 1000)
    n_fft = 1 << (frame_len - 1).bit_length()
    frames = wav.float().unfold(-1, frame_len, frame_shift)  # (B, T, frame_len)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - preemphasis * prev
    frames = frames * torch.from_numpy(_povey_window(frame_len).astype(np.float32)).to(frames.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real**2 + spec.imag**2
    fb = torch.from_numpy(_kaldi_mel_banks(num_mel_bins, n_fft, sample_frequency)).to(frames.device)
    return torch.log(torch.clamp_min(power @ fb.t(), 1.1920928955078125e-07))


def relu20(x):
    return torch.clamp(x, 0.0, 20.0)  # ref ReLU = Hardtanh(0, 20)


class BN(nn.Module):
    """Inference BatchNorm2d on running statistics (no num_batches_tracked)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        s = torch.rsqrt(self.running_var + 1e-5) * self.weight
        return (x - self.running_mean[:, None, None]) * s[:, None, None] + self.bias[:, None, None]


class AFF(nn.Module):
    """Attentional feature fusion (ref eres2net/fusion.py:9)."""

    def __init__(self, channels: int, r: int = 4):
        super().__init__()
        inter = channels // r
        self.local_att = nn.Sequential(
            nn.Conv2d(2 * channels, inter, 1), BN(inter), nn.SiLU(), nn.Conv2d(inter, channels, 1), BN(channels)
        )

    def forward(self, x, ds_y):
        att = 1.0 + torch.tanh(self.local_att(torch.cat([x, ds_y], dim=1)))
        return x * att + ds_y * (2.0 - att)


class BasicBlock(nn.Module):
    """Res2Net block; fuse adds AFF between the scale branches."""

    def __init__(self, in_planes, planes, stride=1, base_width=26, scale=2, expansion=2, fuse=False):
        super().__init__()
        width = int(np.floor(planes * (base_width / 64.0)))
        self.width, self.scale, self.fuse = width, scale, fuse
        self.conv1 = nn.Conv2d(in_planes, width * scale, 1, stride=stride, bias=False)
        self.bn1 = BN(width * scale)
        self.convs = nn.ModuleList(nn.Conv2d(width, width, 3, padding=1, bias=False) for _ in range(scale))
        self.bns = nn.ModuleList(BN(width) for _ in range(scale))
        if fuse:
            self.fuse_models = nn.ModuleList(AFF(width) for _ in range(scale - 1))
        self.conv3 = nn.Conv2d(width * scale, planes * expansion, 1, bias=False)
        self.bn3 = BN(planes * expansion)
        if stride != 1 or in_planes != expansion * planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, expansion * planes, 1, stride=stride, bias=False), BN(expansion * planes)
            )
        else:
            self.shortcut = None

    def forward(self, x):
        out = relu20(self.bn1(self.conv1(x)))
        parts = torch.split(out, self.width, dim=1)
        outs = []
        sp = None
        for i in range(self.scale):
            if i == 0:
                sp = parts[i]
            elif self.fuse:
                sp = self.fuse_models[i - 1](sp, parts[i])
            else:
                sp = sp + parts[i]
            sp = relu20(self.bns[i](self.convs[i](sp)))
            outs.append(sp)
        out = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        sc = x if self.shortcut is None else self.shortcut(x)
        return relu20(out + sc)


@dataclass(frozen=True)
class ERes2NetConfig:
    num_blocks: Sequence[int] = (3, 4, 6, 3)
    m_channels: int = 64
    feat_dim: int = 80
    base_width: int = 24
    scale: int = 4
    expansion: int = 4


class ERes2NetV2(nn.Module):
    def __init__(self, cfg: ERes2NetConfig = ERes2NetConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.conv1 = nn.Conv2d(1, c.m_channels, 3, padding=1, bias=False)
        self.bn1 = BN(c.m_channels)
        in_planes = c.m_channels
        for li, (mult, stride, fuse) in enumerate([(1, 1, False), (2, 2, False), (4, 2, True), (8, 2, True)]):
            planes = c.m_channels * mult
            blocks = []
            for bi in range(c.num_blocks[li]):
                blocks.append(BasicBlock(in_planes, planes, stride if bi == 0 else 1, c.base_width, c.scale,
                                         c.expansion, fuse))
                in_planes = planes * c.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        top = c.m_channels * 8 * c.expansion
        self.layer3_ds = nn.Conv2d(c.m_channels * 4 * c.expansion, top, 3, stride=2, padding=1, bias=False)
        self.fuse34 = AFF(top)

    def forward(self, feat):
        """feat (B, T, 80) kaldi fbank -> (B, C * F') sv embedding."""
        x = feat.transpose(1, 2)[:, None]  # (B, 1, F, T)
        x = relu20(self.bn1(self.conv1(x)))
        out1 = self.layer1(x)
        out2 = self.layer2(out1)
        out3 = self.layer3(out2)
        out4 = self.layer4(out3)
        fused = self.fuse34(out4, self.layer3_ds(out3))
        b, ch, fdim, tdim = fused.shape
        return fused.reshape(b, ch * fdim, tdim).mean(dim=-1)
