"""BigVGAN vocoder GAN training (port of
gpt_sovits_tpu/train/bigvgan_train.py; the vendored BigVGAN/train.py:75-84).

The generator trains against the multi-period discriminator and the
multi-resolution STFT discriminator (DiscriminatorR x3) with the
adversarial, feature-matching and multi-scale mel losses (lambda_mel 15).
Like the JAX module this is a library with no entry point: `init_state` builds
the two optimizers, `make_train_step` one D-then-G update. The generator
is built with `BigVGAN(cfg, use_kernel=False)`: its snakes run the plain
up -> snakeβ -> down composition, which has a backward (K6 has none and
refuses an input that requires a gradient), as the JAX package trains with
`use_pallas=False`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn as nn

from gpt_sovits_tpu_torch.dsp.mel import mel_spectrogram
from gpt_sovits_tpu_torch.models.discriminators import (
    MultiPeriodDiscriminator, MultiResolutionDiscriminator, discriminator_loss, feature_loss, generator_loss,
)
from gpt_sovits_tpu_torch.utils.config import MelConfig, TrainConfig

PERIODS = (2, 3, 5, 7, 11)
RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


class BigVGANDiscriminators(nn.Module):
    """The MPD (`mpd`) and MRD (`mrd`) with their outputs concatenated, as
    the vendored trainer sums loss_f and loss_s terms."""

    def __init__(self, periods=PERIODS, resolutions=RESOLUTIONS):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods)
        self.mrd = MultiResolutionDiscriminator(resolutions)

    def forward(self, y, y_hat):
        """y, y_hat (B, L, 1) -> (real scores, fake scores, real maps, fake maps)."""
        r1, g1, fr1, fg1 = self.mpd(y, y_hat)
        r2, g2, fr2, fg2 = self.mrd(y, y_hat)
        return r1 + r2, g1 + g2, fr1 + fr2, fg1 + fg2


def multiscale_mel_loss(y: torch.Tensor, y_hat: torch.Tensor, base: MelConfig, *, n_scales: int = 3):
    """The mean over n_scales of the L1 between log-mels of y and y_hat
    (B, L), n_fft / win / hop halved each scale with floors 64 / 64 / 16
    (BigVGAN use_multiscale_melloss)."""
    loss = 0.0
    for s in range(n_scales):
        f = 2**s
        cfg = replace(base, n_fft=max(base.n_fft // f, 64), win_size=max(base.win_size // f, 64),
                      hop_size=max(base.hop_size // f, 16))
        loss = loss + torch.mean(torch.abs(mel_spectrogram(y, cfg) - mel_spectrogram(y_hat, cfg)))
    return loss / n_scales


@dataclass
class BigVGANTrainState:
    """The two optimizers: AdamW (TrainConfig's lr, betas and eps, optax's
    weight decay 1e-4), no schedule."""

    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0


def _adamw(module: nn.Module, cfg: TrainConfig) -> torch.optim.Optimizer:
    return torch.optim.AdamW(module.parameters(), lr=cfg.learning_rate, betas=tuple(cfg.betas), eps=cfg.eps,
                             weight_decay=1e-4)


def init_state(gen: nn.Module, disc: BigVGANDiscriminators, cfg: TrainConfig) -> BigVGANTrainState:
    return BigVGANTrainState(_adamw(gen, cfg), _adamw(disc, cfg))


def make_train_step(gen: nn.Module, disc: BigVGANDiscriminators, state: BigVGANTrainState, mel: MelConfig, *,
                    lambda_mel: float = 15.0):
    """-> step(batch) -> metrics for batch {"mel" (B, T, M), "wav" (B, T*hop, 1)}:
    D on the detached fake first, then G (adv + fm + lambda_mel x the
    multi-scale mel L1) against the updated D. The gradients stay in each
    parameter's `.grad`. Metrics (detached): loss_g, loss_d, loss_adv,
    loss_fm, loss_mel."""

    def step(batch: dict) -> dict:
        wav = batch["wav"]
        y_hat = gen(batch["mel"])

        disc.requires_grad_(True)
        state.opt_d.zero_grad(set_to_none=True)
        r, g, _, _ = disc(wav, y_hat.detach())
        loss_d, _, _ = discriminator_loss(r, g)
        loss_d.backward()
        state.opt_d.step()

        disc.requires_grad_(False)
        r, g, fr, fg = disc(wav, y_hat)
        loss_adv, _ = generator_loss(g)
        loss_fm = feature_loss(fr, fg)
        loss_mel = multiscale_mel_loss(wav[..., 0], y_hat[..., 0], mel) * lambda_mel
        loss_g = loss_adv + loss_fm + loss_mel
        state.opt_g.zero_grad(set_to_none=True)
        loss_g.backward()
        state.opt_g.step()
        disc.requires_grad_(True)
        state.step += 1
        metrics = {"loss_adv": loss_adv, "loss_fm": loss_fm, "loss_mel": loss_mel, "loss_g": loss_g, "loss_d": loss_d}
        return {k: v.detach() for k, v in metrics.items()}

    return step
