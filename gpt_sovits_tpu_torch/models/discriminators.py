"""GAN discriminators and losses for S2 (and, later, BigVGAN) training
(port of gpt_sovits_tpu/models/discriminators.py).

Module names are the reference's (module/models.py:481-618,
BigVGAN/discriminators.py), those that the JAX package's
`checkpoint_compat.d_params_from_torch` reads: `discriminators.{i}.convs.{j}`
and `.conv_post`. Weights are plain (the reference trains them under weight
norm; `load_state_dict` folds such pairs). Waveforms are (B, T, 1), as in
the JAX package; inside, channels-first.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gpt_sovits_tpu_torch import at_least_f32
from gpt_sovits_tpu_torch.models.vits_modules import LRELU_SLOPE

PERIODS = (2, 3, 5, 7, 11)
PERIODS_PRO = PERIODS + (17, 23)  # v2Pro/v2ProPlus (models.py:596-599)


def periods_for(s2_cfg) -> tuple:
    return PERIODS_PRO if s2_cfg.is_pro else PERIODS


class DiscriminatorS(nn.Module):
    SPECS = ((1, 16, 15, 1, 1), (16, 64, 41, 4, 4), (64, 256, 41, 4, 16), (256, 1024, 41, 4, 64),
             (1024, 1024, 41, 4, 256), (1024, 1024, 5, 1, 1))  # (in, out, kernel, stride, groups)

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv1d(i, o, k, s, groups=g, padding=k // 2) for i, o, k, s, g in self.SPECS)
        self.conv_post = nn.Conv1d(1024, 1, 3, 1, padding=1)

    def forward(self, x):
        """x (B,1,T) -> (score (B, -1), feature maps)."""
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        chans = (1, 32, 128, 512, 1024)
        convs = [nn.Conv2d(chans[i], chans[i + 1], (kernel_size, 1), (stride, 1), padding=(pad, 0)) for i in range(4)]
        convs.append(nn.Conv2d(1024, 1024, (kernel_size, 1), 1, padding=(pad, 0)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x):
        """x (B,1,T) -> the (B,1,T/p,p) view, reflect-padded to a whole period."""
        b, c, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            t += n_pad
        x = x.view(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


def _mrd_magnitude(x, n_fft: int, hop: int, win: int):
    """|STFT| the way the vendored MRD computes it (BigVGAN/
    discriminators.py:215-232): reflect-pad (n_fft-hop)/2, center=False, a
    rectangular window of `win` centred in the frame, as a frame product with
    real-DFT bases (the JAX package's form). x (B,1,T) -> (B, F, frames)."""
    pad = (n_fft - hop) // 2
    y = F.pad(x, (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop)  # (B, frames, n_fft)
    if win < n_fft:
        lo = (n_fft - win) // 2
        mask = torch.zeros(n_fft, device=x.device)
        mask[lo : lo + win] = 1.0
        frames = frames * mask
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos = torch.from_numpy(np.cos(ang)).to(x.device, x.dtype)  # float32, or float64 for a float64 run
    sin = torch.from_numpy(-np.sin(ang)).to(x.device, x.dtype)
    re, im = frames @ cos, frames @ sin
    return torch.sqrt(re * re + im * im + 1e-9).transpose(1, 2)


class DiscriminatorR(nn.Module):
    """One resolution of the multi-resolution (STFT) discriminator
    (BigVGAN/discriminators.py:140-236): 32 channels, (3,9) kernels, three
    stride-(1,2) stages over time."""

    def __init__(self, resolution: Sequence[int]):
        super().__init__()
        self.resolution = tuple(resolution)
        specs = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 3), (1, 1)))
        self.convs = nn.ModuleList(
            nn.Conv2d(1 if i == 0 else 32, 32, k, s, padding=((k[0] - 1) // 2, (k[1] - 1) // 2))
            for i, (k, s) in enumerate(specs)
        )
        self.conv_post = nn.Conv2d(32, 1, (3, 3), padding=(1, 1))

    def forward(self, x):
        h = _mrd_magnitude(x, *self.resolution)[:, None]  # (B,1,F,frames)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), 0.1)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.flatten(1), fmap


def _fold(state_dict: dict) -> dict:
    """Drop DDP's `module.` prefix and fold weight-norm pairs."""
    from gpt_sovits_tpu_torch.models.vits import fold_weight_norm

    return fold_weight_norm({k.removeprefix("module."): v for k, v in state_dict.items()})


class _MultiDiscriminator(nn.Module):
    def forward(self, y, y_hat):
        """y, y_hat (B,T,1) -> (y_d_rs, y_d_gs, fmap_rs, fmap_gs), one entry a
        discriminator."""
        y, y_hat = y.transpose(1, 2), y_hat.transpose(1, 2)
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            r, fr = d(y)
            g, fg = d(y_hat)
            y_d_rs.append(r)
            y_d_gs.append(g)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        return super().load_state_dict(_fold(state_dict), strict=strict, assign=assign)


class MultiPeriodDiscriminator(_MultiDiscriminator):
    """DiscriminatorS + one DiscriminatorP a period (models.py:585)."""

    def __init__(self, periods: Sequence[int] = PERIODS):
        super().__init__()
        self.periods = tuple(periods)
        self.discriminators = nn.ModuleList([DiscriminatorS()] + [DiscriminatorP(p) for p in self.periods])


class MultiResolutionDiscriminator(_MultiDiscriminator):
    """Three DiscriminatorR resolutions (BigVGAN/discriminators.py:239-271)."""

    def __init__(self, resolutions=((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorR(r) for r in resolutions)


# ---------------------------------------------------------------------------
# Losses (ref module/losses.py)
# ---------------------------------------------------------------------------


def feature_loss(fmap_r, fmap_g):
    """L1 feature matching x2 (losses.py:6); the real maps are constants."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach() - gl))
    return loss * 2.0


def discriminator_loss(disc_real, disc_gen):
    """LSGAN D loss (losses.py:17) -> (loss, real losses, fake losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r_loss = torch.mean((1.0 - at_least_f32(dr)) ** 2)
        g_loss = torch.mean(at_least_f32(dg) ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN G adversarial loss (losses.py:33) -> (loss, per-discriminator)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean((1.0 - at_least_f32(dg)) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask, mask_total=None):
    """KL(q||p) between the posterior and the flow-mapped prior (losses.py:45);
    all (B,T,C), z_mask (B,T,1). The sum is divided by the mask's sum, or by
    `mask_total` where given (a data-parallel rank's share of the global
    batch divides by the global count)."""
    z_p, logs_q, m_p, logs_p = (at_least_f32(v) for v in (z_p, logs_q, m_p, logs_p))
    kl = logs_p - logs_q - 0.5 + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / (torch.sum(z_mask) if mask_total is None else mask_total)
