"""S2 GAN training: one generator + discriminator update (port of
gpt_sovits_tpu/train/s2_train.py; the reference's GPT_SoVITS/s2_train.py).

Loss recipe (s2_train.py:432-461):
  D: LSGAN loss on (real, fake.detach()); D updates first,
  G: adv + feature matching + c_mel * mel L1 + c_kl * KL + VQ commit, all
     against the updated D.
One generator forward serves both halves (the JAX step's two forwards use
the same key and are equal).

Optimizers (s2_train.py:172-192): AdamW(lr, betas (0.8, 0.99), eps 1e-9,
weight decay 1e-4, optax's default) for G and D; enc_p's text_embedding,
encoder_text and mrte at lr * text_low_lr_rate; `ssl_proj` and `quantizer`
frozen (no gradient, no update, no weight decay) under freeze_quantizer,
as the reference's `requires_grad_(False)`; the learning rate decays
continuously, lr * lr_decay ** (updates / steps_per_epoch)
(optax.exponential_decay, not ExponentialLR's staircase).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from gpt_sovits_tpu_torch.dsp.mel import mel_spectrogram, spec_to_mel
from gpt_sovits_tpu_torch.models.discriminators import (
    discriminator_loss, feature_loss, generator_loss, kl_loss,
)
from gpt_sovits_tpu_torch.models.vits import slice_segments
from gpt_sovits_tpu_torch.parallel import sync
from gpt_sovits_tpu_torch.train.optim import MultiStepOptimizer
from gpt_sovits_tpu_torch.utils.config import MelConfig, TrainConfig

TEXT_MODULES = ("enc_p.text_embedding.", "enc_p.encoder_text.", "enc_p.mrte.")
FROZEN_MODULES = ("ssl_proj.", "quantizer.")


@dataclass
class VQEmaState:
    """EMA-kmeans codebook statistics (core_vq.py EuclideanCodebook's
    cluster_size and embed_avg buffers)."""

    cluster_size: torch.Tensor  # (K,)
    embed_avg: torch.Tensor  # (K, D)

    @classmethod
    def init(cls, embed: torch.Tensor) -> "VQEmaState":
        return cls(torch.zeros(embed.shape[0], device=embed.device), embed.detach().clone())


@torch.no_grad()
def vq_ema_update(embed, state: VQEmaState, x, codes, *, decay: float = 0.99, epsilon: float = 1e-5):
    """One EMA-kmeans codebook step (core_vq.py:199-225): EMA of the codes'
    counts and sums, then a Laplace-smoothed mean. x (N, D), codes (N,).
    -> (new embed, new state). Training from scratch applies it after each
    step; the fine-tune recipe keeps the quantizer frozen and never does.
    With a process group the counts and sums are the global batch's (summed
    over the ranks), so every replica keeps the same codebook."""
    k = embed.shape[0]
    onehot = F.one_hot(codes.long(), k).to(x.dtype)
    cluster_size = state.cluster_size * decay + sync.all_sum(onehot.sum(0)) * (1 - decay)
    embed_avg = state.embed_avg * decay + sync.all_sum(onehot.T @ x) * (1 - decay)
    n = cluster_size.sum()
    smoothed = (cluster_size + epsilon) / (n + k * epsilon) * n
    return embed_avg / smoothed[:, None], VQEmaState(cluster_size, embed_avg)


def label_params_g(gen, freeze_quantizer: bool) -> dict[str, str]:
    """parameter name -> "frozen" (the top-level ssl_proj and quantizer under
    freeze_quantizer), "text" (enc_p's text modules) or "base"."""
    labels = {}
    for name, _ in gen.named_parameters():
        if freeze_quantizer and name.startswith(FROZEN_MODULES):
            labels[name] = "frozen"
        elif name.startswith(TEXT_MODULES):
            labels[name] = "text"
        else:
            labels[name] = "base"
    return labels


def _adamw(groups: list[dict], cfg: TrainConfig, steps_per_epoch: int) -> MultiStepOptimizer:
    """AdamW with optax's defaults; group g's lr at update n is
    learning_rate * g's lr_scale * lr_decay ** (n / steps_per_epoch)."""
    inner = torch.optim.AdamW([g for g in groups if g["params"]], lr=cfg.learning_rate, betas=tuple(cfg.betas),
                              eps=cfg.eps, weight_decay=1e-4)
    return MultiStepOptimizer(inner, lambda n: cfg.learning_rate * cfg.lr_decay ** (n / steps_per_epoch),
                              grad_clip=None)


def make_optimizer_g(gen, cfg: TrainConfig, steps_per_epoch: int = 100) -> MultiStepOptimizer:
    """base at cfg.learning_rate, text at * text_low_lr_rate; frozen
    parameters stop requiring gradients and join no group."""
    labels = label_params_g(gen, gen.cfg.freeze_quantizer)
    groups = {"base": [], "text": []}
    for name, p in gen.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    return _adamw([{"params": groups["base"]}, {"params": groups["text"], "lr_scale": cfg.text_low_lr_rate}],
                  cfg, steps_per_epoch)


def make_optimizer_d(disc, cfg: TrainConfig, steps_per_epoch: int = 100) -> MultiStepOptimizer:
    return _adamw([{"params": list(disc.parameters())}], cfg, steps_per_epoch)


def make_train_step(gen, disc, opt_g: MultiStepOptimizer, opt_d: MultiStepOptimizer, train_cfg: TrainConfig,
                    mel_cfg: MelConfig):
    """-> step(batch, generator=None, *, noise=None, ids_slice=None) -> metrics:
    one D update, then one G update against the updated D. `batch` holds
    tensors on the models' device (data.py `batch_to`); noise and segment
    starts are drawn from `generator` unless given (SynthesizerTrn.forward).
    The gradients stay in each parameter's `.grad`. Metrics are detached
    tensors, the global batch's: loss_g, loss_d and loss_adv/fm/mel/kl/commit.
    With a process group each rank scales its batch means by 1/world and
    divides the KL by the global mask count, and the gradients are summed
    (parallel/sync.py)."""
    hop = mel_cfg.hop_size
    seg = gen.cfg.segment_size

    def step(batch: dict, generator: Optional[torch.Generator] = None, *, noise=None, ids_slice=None) -> dict:
        n = sync.world()
        out = gen(batch["ssl"], batch["spec"], batch["spec_lengths"], batch["text"], batch["text_lengths"],
                  sv_emb=batch.get("sv_emb"), noise=noise, ids_slice=ids_slice, generator=generator)
        starts = out["ids_slice"]
        wav_real = slice_segments(batch["wav"], starts * hop, seg * hop)
        wav_hat = out["wav_hat"]

        # ---- D step, on the detached fake ----
        disc.requires_grad_(True)
        opt_d.zero_grad()
        y_d_rs, y_d_gs, _, _ = disc(wav_real, wav_hat.detach())
        loss_d = discriminator_loss(y_d_rs, y_d_gs)[0] / n
        loss_d.backward()
        sync.all_reduce_grads(opt_d.params)
        opt_d.step()

        # ---- G step, against the updated D ----
        disc.requires_grad_(False)
        mel_real = slice_segments(spec_to_mel(batch["spec"].transpose(1, 2), mel_cfg).transpose(1, 2), starts, seg)
        mel_hat = mel_spectrogram(wav_hat[..., 0], mel_cfg).transpose(1, 2)
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = disc(wav_real, wav_hat)
        loss_adv = generator_loss(y_d_gs)[0] / n
        loss_fm = feature_loss(fmap_rs, fmap_gs) / n
        loss_mel = torch.mean(torch.abs(mel_real - mel_hat)) * train_cfg.c_mel / n
        mask_total = None if n == 1 else sync.all_sum(out["y_mask"].sum())
        loss_kl = kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"], out["y_mask"],
                          mask_total) * train_cfg.c_kl
        loss_commit = out["commit_loss"] / n
        loss_g = loss_adv + loss_fm + loss_mel + loss_kl + loss_commit
        opt_g.zero_grad()
        loss_g.backward()
        sync.all_reduce_grads(opt_g.params)
        opt_g.step()
        disc.requires_grad_(True)
        metrics = {"loss_adv": loss_adv, "loss_fm": loss_fm, "loss_mel": loss_mel, "loss_kl": loss_kl,
                   "loss_commit": loss_commit, "loss_g": loss_g, "loss_d": loss_d}
        return {k: sync.all_sum(v) for k, v in metrics.items()}

    return step
