"""BigVGAN-v2 vocoder of the v3 path: 100-band mel at 24 kHz -> waveform,
x256 (port of gpt_sovits_tpu/models/bigvgan.py; reference
GPT_SoVITS/BigVGAN/bigvgan.py:226 and activations.py).

Convolutions are `nn.Conv1d` / `nn.ConvTranspose1d` on PyTorch's (B, C, T)
layout; every anti-aliased snakeβ (`AntiAliasedSnake`, the reference's
`Activation1d`) goes through ops/snake_aa.py: K6 on a card, its plain twin
on the CPU. The JAX package's lane-folded rewrite (ops/folded_bigvgan.py)
exists only for the TPU's 128-lane tiling and has no counterpart here.

Module and parameter names are the reference checkpoint's: `conv_pre`,
`ups.{i}.0`, `resblocks.{k}.convs1.{d}` / `convs2.{d}`,
`resblocks.{k}.activations.{2d|2d+1}.act.alpha|beta`,
`activation_post.act.alpha|beta`, `conv_post` (no bias); weight-norm pairs
are folded at load. The reference's fixed resampling filters
(`*.upsample.filter`, `*.downsample.lowpass.filter`) are not parameters
here: they are computed from `kaiser_sinc_filter1d`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn

from gpt_sovits_tpu_torch.models.vits import fold_weight_norm
from gpt_sovits_tpu_torch.ops.snake_aa import snake_aa


@dataclass(frozen=True)
class BigVGANConfig:
    """configs/bigvgan_v2_24khz_100band_256x.json."""

    num_mels: int = 100
    upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    snake_logscale: bool = True
    use_tanh_at_final: bool = False
    use_bias_at_final: bool = False


class _SnakeBeta(nn.Module):
    """The reference's SnakeBeta parameters: log-scale alpha and beta per
    channel (zeros), or linear ones (ones)."""

    def __init__(self, channels: int, logscale: bool):
        super().__init__()
        init = torch.zeros if logscale else torch.ones
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels))


class AntiAliasedSnake(nn.Module):
    """Activation1d: up x2 -> snakeβ -> down x2 on (B, C, T), through K6
    (ops/snake_aa.py); alpha and beta enter in f32 whatever the module's
    dtype."""

    def __init__(self, channels: int, logscale: bool = True):
        super().__init__()
        self.logscale = logscale
        self.act = _SnakeBeta(channels, logscale)

    def forward(self, x):
        return snake_aa(x.contiguous(), self.act.alpha.float().contiguous(), self.act.beta.float().contiguous(),
                        logscale=self.logscale)


class AMPBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5),
                 logscale: bool = True):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d, padding=(kernel_size - 1) * d // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2) for _ in dilations)
        # stored interleaved as in the reference: [act1_0, act2_0, act1_1, ...]
        self.activations = nn.ModuleList(AntiAliasedSnake(channels, logscale) for _ in range(2 * len(dilations)))

    def forward(self, x):
        for d, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            x = c2(self.activations[2 * d + 1](c1(self.activations[2 * d](x)))) + x
        return x


class BigVGAN(nn.Module):
    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        self.cfg = c = cfg
        uic = c.upsample_initial_channel
        self.n_k = len(c.resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(c.num_mels, uic, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch = uic // (2 ** (i + 1))
            self.ups.append(nn.ModuleList([nn.ConvTranspose1d(uic // (2**i), ch, k, u, padding=(k - u) // 2)]))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(AMPBlock1(ch, rk, tuple(rd), c.snake_logscale))
        self.activation_post = AntiAliasedSnake(ch, c.snake_logscale)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=c.use_bias_at_final)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Reference-named weights, weight-norm pairs folded here."""
        return super().load_state_dict(fold_weight_norm(dict(state_dict)), strict=strict, assign=assign)

    def forward(self, mel):
        """(B, T, num_mels) -> (B, T * prod(rates), 1), clamped to [-1, 1]
        (tanh where the config asks for it)."""
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up[0](x)
            xs = None
            for j in range(self.n_k):
                r = self.resblocks[i * self.n_k + j](x)
                xs = r if xs is None else xs + r
            x = xs / self.n_k
        x = self.conv_post(self.activation_post(x))
        x = torch.tanh(x) if self.cfg.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)
        return x.transpose(1, 2)
