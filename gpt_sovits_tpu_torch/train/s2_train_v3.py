"""v3/v4 CFM training: full fine-tune and LoRA (port of
gpt_sovits_tpu/train/s2_train_v3.py; the reference's s2_train_v3.py and
s2_train_v3_lora.py). No discriminator: the loss is the flow-matching MSE
of SynthesizerTrnV3.forward (models.py:1214-1242).

  * Full fine-tune: ssl_proj, quantizer and enc_p are frozen (no gradient,
    no update, no weight decay: optax's set_to_zero; models.py:1212-1215);
    everything else trains under AdamW with TrainConfig's betas and eps,
    optax's weight decay 1e-4 and the continuous
    optax.exponential_decay(lr, steps_per_epoch, lr_decay), counted in
    updates; no clip, no accumulation.
  * LoRA: low-rank factors on every DiT block's to_q/to_k/to_v/to_out
    weight (s2_train_v3_lora.py:134-139), A (r, in) ~ N(0, 1)/sqrt(r) and
    B (out, r) = 0, so the delta B @ A starts at 0 (peft's default). Only
    the factors train, under AdamW with the same schedule; the base
    weights are never written. The step is functional, as in the JAX
    package: the model runs with W + scale * B @ A in place of each target
    (torch.func.functional_call), and the export merges them
    (merge_lora, scale 1, TTS.py:560-572 merge_and_unload).

With a process group (parallel/), each rank's loss is scaled by 1/world
and the gradients are summed (parallel/sync.py): the update is the global
batch's. The bootstrap coin, one for the whole batch, is rank 0's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call

from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3, draw_cfm
from gpt_sovits_tpu_torch.parallel import sync
from gpt_sovits_tpu_torch.train.optim import MultiStepOptimizer
from gpt_sovits_tpu_torch.utils.config import TrainConfig

FROZEN_V3 = ("ssl_proj.", "quantizer.", "enc_p.")
LORA_TARGETS = ("attn.to_q.weight", "attn.to_k.weight", "attn.to_v.weight", "attn.to_out.0.weight")
BATCH_KEYS = ("ssl", "spec", "spec_lengths", "mel", "mel_lengths", "text", "text_lengths")


def label_params(model: SynthesizerTrnV3) -> dict[str, str]:
    """parameter name -> "frozen" (ssl_proj, quantizer, enc_p) or "base"."""
    return {n: "frozen" if n.startswith(FROZEN_V3) else "base" for n, _ in model.named_parameters()}


def _adamw(params: list, cfg: TrainConfig, steps_per_epoch: int) -> MultiStepOptimizer:
    """optax.adamw(exponential_decay(lr, steps_per_epoch, lr_decay)) with its
    default weight decay 1e-4."""
    inner = torch.optim.AdamW(params, lr=cfg.learning_rate, betas=tuple(cfg.betas), eps=cfg.eps, weight_decay=1e-4)
    return MultiStepOptimizer(inner, lambda n: cfg.learning_rate * cfg.lr_decay ** (n / steps_per_epoch),
                              grad_clip=None)


def make_optimizer(model: SynthesizerTrnV3, cfg: TrainConfig, steps_per_epoch: int = 100) -> MultiStepOptimizer:
    """The full fine-tune's optimizer; frozen parameters stop requiring
    gradients and join no group."""
    labels = label_params(model)
    base = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "base")
        if labels[name] == "base":
            base.append(p)
    return _adamw(base, cfg, steps_per_epoch)


def step_draws(model: SynthesizerTrnV3, batch: dict, generator: Optional[torch.Generator]) -> dict:
    """One step's CFM draws (models/v3.py draw_cfm) at the length the forward
    crops to, with rank 0's bootstrap coin on every rank."""
    tq = 2 * (batch["ssl"].shape[1] // 2)  # ssl_proj halves, the codes repeat x2
    t = min(batch["mel"].shape[1], int(tq * model.interp_factor))
    draws = draw_cfm(batch["mel"].shape[0], t, batch["mel"].shape[2], generator)
    draws["use_boot"] = sync.from_rank0(draws["use_boot"])
    return draws


def make_train_step(model: SynthesizerTrnV3, optimizer: MultiStepOptimizer):
    """-> step(batch, generator=None, *, draws=None) -> {"cfm_loss"}: one
    update. `batch` holds tensors on the model's device (data.py
    `batch_to`); the draws come from `generator` unless given. The
    gradients stay in each parameter's `.grad`; cfm_loss is the global
    batch's, detached."""

    def step(batch: dict, generator: Optional[torch.Generator] = None, *, draws=None) -> dict:
        if draws is None:
            draws = step_draws(model, batch, generator)
        optimizer.zero_grad()
        loss = model(*(batch[k] for k in BATCH_KEYS), draws=draws) / sync.world()
        loss.backward()
        sync.all_reduce_grads(optimizer.params)
        optimizer.step()
        return {"cfm_loss": sync.all_sum(loss)}

    return step


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def lora_targets(model: SynthesizerTrnV3) -> list[str]:
    """The weights LoRA adapts: every DiT block's to_q, to_k, to_v, to_out."""
    return [n for n, _ in model.named_parameters()
            if n.startswith("cfm.estimator.transformer_blocks.") and n.endswith(LORA_TARGETS)]


def init_lora(model: SynthesizerTrnV3, rank: int, generator: Optional[torch.Generator] = None) -> dict:
    """{target name: {"A": (r, in) ~ N(0, 1)/sqrt(r), "B": (out, r) zeros}},
    leaf tensors that require gradients, on the model's device."""
    params = dict(model.named_parameters())
    lora = {}
    for name in lora_targets(model):
        w = params[name]
        a = torch.randn((rank, w.shape[1]), generator=generator) / rank**0.5
        lora[name] = {"A": a.to(w.device, w.dtype).requires_grad_(True),
                      "B": torch.zeros((w.shape[0], rank), device=w.device, dtype=w.dtype, requires_grad=True)}
    return lora


def merged_weights(model, lora: dict, scale: float = 1.0) -> dict:
    """{target name: W + scale * B @ A}, differentiable in the factors."""
    params = dict(model.named_parameters())
    return {n: params[n] + scale * (f["B"] @ f["A"]) for n, f in lora.items()}


@torch.no_grad()
def merge_lora(state_dict: dict, lora: dict, scale: float = 1.0) -> dict:
    """A state dict with each target replaced by W + scale * B @ A (the
    export-time merge)."""
    out = dict(state_dict)
    for n, f in lora.items():
        out[n] = state_dict[n] + scale * (f["B"] @ f["A"]).to(state_dict[n])
    return out


def make_lora_optimizer(lora: dict, cfg: TrainConfig, steps_per_epoch: int = 100) -> MultiStepOptimizer:
    return _adamw([f[k] for _, f in sorted(lora.items()) for k in ("A", "B")], cfg, steps_per_epoch)


def make_lora_train_step(model: SynthesizerTrnV3, lora: dict, optimizer: MultiStepOptimizer):
    """-> step(batch, generator=None, *, draws=None) -> {"cfm_loss"}: one
    update of the LoRA factors only. The model's own parameters stop
    requiring gradients and are never written."""
    model.requires_grad_(False)

    def step(batch: dict, generator: Optional[torch.Generator] = None, *, draws=None) -> dict:
        if draws is None:
            draws = step_draws(model, batch, generator)
        optimizer.zero_grad()
        loss = functional_call(model, merged_weights(model, lora), tuple(batch[k] for k in BATCH_KEYS),
                               {"draws": draws}, strict=False) / sync.world()
        loss.backward()
        sync.all_reduce_grads(optimizer.params)
        optimizer.step()
        return {"cfm_loss": sync.all_sum(loss)}

    return step
