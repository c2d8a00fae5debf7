"""BigVGAN-v2 (NVIDIA's `bigvgan_v2_24khz_100band_256x`: bigvgan.py
`BigVGAN`, `AMPBlock1`; activations.py `SnakeBeta`; alias_free_activation/
torch/ `Activation1d`, `UpSample1d`, `DownSample1d`, `kaiser_sinc_filter1d`),
written out in plain PyTorch for the benchmark's reference. It imports
nothing of the program; the resampling filters are computed here.

The published description, and where this copy departs from it:
  * a 7-tap input convolution to 1536 channels; six transposed
    convolutions (rates 4, 4, 2, 2, 2, 2, kernels 8, 8, 4, 4, 4, 4, padding
    (k - u) / 2), each halving the channels; after each, the mean of three
    AMP blocks (kernels 3, 7, 11, dilations 1, 3, 5); an anti-aliased
    snakeβ; a 7-tap output convolution to one channel without bias; no
    tanh: the output is clamped to [-1, 1];
  * an AMP block is, for each dilation d: x + conv2(act2(conv1_d(act1(x)))),
    conv1 dilated by d, conv2 not;
  * the anti-aliased snakeβ is an x2 upsample (a 12-tap kaiser-windowed
    sinc, cutoff 0.25, half-width 0.3, over the input replicate-padded by
    5 on each side, a transposed convolution of stride 2 scaled by 2, then
    15 samples cut from each end), snakeβ x + sin²(e^α x) / (e^β + 1e-9)
    with log-scale per-channel α and β, and an x2 downsample (the same
    filter over the stream replicate-padded by 5 on the left and 6 on the
    right, stride 2);
  * departures: the weight-norm pairs are folded into plain weights (what
    `remove_weight_norm` does before inference); the model takes and
    returns the benchmark's layout, (B, frames, mels) -> (B, samples, 1);
    a copy cast to another dtype computes the activation in float32 and
    returns the copy's dtype (the published module computes it in its own
    dtype), so that a bf16 copy's error is that of its convolutions and of
    the bf16 values between layers, the precision the configuration states.

Parameter names are the published checkpoint's (`conv_pre`, `ups.{i}.0`,
`resblocks.{k}.convs1.{d}`, `resblocks.{k}.activations.{j}.act.alpha`,
`activation_post.act.beta`, `conv_post`), so the benchmark's weight streams
give this copy and the program the same values.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port.reference.common import at_least_f32

RATIO = 2  # the activation's up and down ratio
TAPS = 12  # int(6 * RATIO // 2) * 2


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """A kaiser-windowed sinc low-pass of `kernel_size` taps, summing to 1
    (alias_free_activation/torch/filter.py `kaiser_sinc_filter1d`), in
    float64."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * (4 * half_width) + 7.95  # the window's attenuation in dB
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if kernel_size % 2 == 0:
        t = np.arange(-half, half) + 0.5
    else:
        t = np.arange(kernel_size) - half
    f = 2 * cutoff * window * np.sinc(2 * cutoff * t)
    return f / f.sum()


FILTER = kaiser_sinc_filter1d(0.5 / RATIO, 0.6 / RATIO, TAPS)


def _filter(x: torch.Tensor) -> torch.Tensor:
    """FILTER as a depthwise weight (C, 1, TAPS) in x's dtype."""
    return torch.as_tensor(FILTER, dtype=x.dtype, device=x.device).view(1, 1, -1).expand(x.shape[1], 1, -1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, C, 2T), `UpSample1d(2, 12)`."""
    pad = TAPS // RATIO - 1
    cut_l = pad * RATIO + (TAPS - RATIO) // 2
    cut_r = pad * RATIO + (TAPS - RATIO + 1) // 2
    y = RATIO * F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), _filter(x), stride=RATIO,
                                   groups=x.shape[1])
    return y[..., cut_l : y.shape[-1] - cut_r]


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 2T) -> (B, C, T), `DownSample1d(2, 12)` (its `LowPassFilter1d`)."""
    return F.conv1d(F.pad(x, (TAPS // 2 - 1, TAPS // 2), mode="replicate"), _filter(x), stride=RATIO,
                    groups=x.shape[1])


class SnakeBeta(nn.Module):
    """Per-channel log-scale α and β (activations.py `SnakeBeta`,
    alpha_logscale=True: both initialised to zeros)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        a = torch.exp(at_least_f32(self.alpha))[None, :, None]
        b = torch.exp(at_least_f32(self.beta))[None, :, None]
        return x + (1.0 / (b + 1e-9)) * torch.sin(x * a) ** 2


class Activation1d(nn.Module):
    """Up x2 -> snakeβ -> down x2, in float32 (see the module's notes)."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)

    def forward(self, x):
        return downsample2(self.act(upsample2(at_least_f32(x)))).to(x.dtype)


class AMPBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d, padding=(kernel_size * d - d) // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2) for _ in dilations)
        self.activations = nn.ModuleList(Activation1d(channels) for _ in range(2 * len(dilations)))

    def forward(self, x):
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.activations[::2], self.activations[1::2]):
            x = c2(a2(c1(a1(x)))) + x
        return x


class BigVGAN(nn.Module):
    """`c` a configuration file's "vocoder" object: num_mels,
    upsample_rates, upsample_kernel_sizes, upsample_initial_channel,
    resblock_kernel_sizes, resblock_dilation_sizes, use_bias_at_final."""

    def __init__(self, c: dict):
        super().__init__()
        uic = c["upsample_initial_channel"]
        self.n_k = len(c["resblock_kernel_sizes"])
        self.conv_pre = nn.Conv1d(c["num_mels"], uic, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
            ch = uic // 2 ** (i + 1)
            self.ups.append(nn.ModuleList([nn.ConvTranspose1d(uic // 2**i, ch, k, u, padding=(k - u) // 2)]))
            for rk, rd in zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]):
                self.resblocks.append(AMPBlock1(ch, rk, rd))
        self.activation_post = Activation1d(ch)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=c["use_bias_at_final"])

    def forward(self, mel):
        """(B, frames, num_mels) -> (B, frames * prod(rates), 1) in [-1, 1]."""
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up[0](x)
            x = sum(self.resblocks[i * self.n_k + j](x) for j in range(self.n_k)) / self.n_k
        x = self.conv_post(self.activation_post(x))
        return torch.clamp(x, -1.0, 1.0).transpose(1, 2)
