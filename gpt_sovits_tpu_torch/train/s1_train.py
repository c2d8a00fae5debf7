"""S1 AR model training with gradient accumulation and DPO (port of
gpt_sovits_tpu/train/s1_train.py).

The optimizer is the JAX package's optax chain, rebuilt over torch:
global-norm clip, then AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay 1e-4,
optax's default, not torch's 1e-2) or ScaledAdam at peak 0.025, behind
MultiSteps(grad_accum) (train/optim.py: the mean of the micro-gradients is
clipped; the schedule counts updates, not micro-steps). The step is a plain
function over (model, optimizer, batch, generator); its randomness (the
DPO rejects) comes from an explicit CPU `torch.Generator`, or is passed in.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from gpt_sovits_tpu_torch.models.t2s import T2SDecoder, t2s_loss
from gpt_sovits_tpu_torch.parallel import sync
from gpt_sovits_tpu_torch.train.optim import MultiStepOptimizer
from gpt_sovits_tpu_torch.train.scaled_adam import ScaledAdam
from gpt_sovits_tpu_torch.utils.config import TrainConfig


def make_schedule(cfg: TrainConfig, *, peak_lr: float = 0.002, cosine: bool = False, decay_steps: int = 40000):
    """-> lr(update count): a linear warm-up from 1e-5 to peak_lr over
    cfg.warmup_steps, then constant (the reference's effective recipe), or
    optax.warmup_cosine_decay_schedule down to 1e-4 at decay_steps."""
    warm_n = cfg.warmup_steps

    def warm(step: int) -> float:  # called for step < warm_n only
        return (1e-5 - peak_lr) * (1.0 - step / warm_n) + peak_lr

    if cosine:
        alpha = 1e-4 / peak_lr
        n_cos = decay_steps - warm_n

        def sched(step: int) -> float:
            if step < warm_n:
                return warm(step)
            c = min(step - warm_n, n_cos)
            return peak_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / n_cos)) + alpha)

        return sched
    return lambda step: warm(step) if step < warm_n else peak_lr


def make_optimizer(params, cfg: TrainConfig, *, optimizer: str = "adamw", **sched_kw) -> MultiStepOptimizer:
    params = list(params)
    if optimizer == "scaled_adam":
        sched = make_schedule(cfg, peak_lr=sched_kw.pop("peak_lr", 0.025), **sched_kw)
        inner = ScaledAdam(params, sched(0))
    elif optimizer == "adamw":
        sched = make_schedule(cfg, **sched_kw)
        inner = torch.optim.AdamW(params, lr=sched(0), betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-4)
    else:
        raise ValueError(f"optimizer {optimizer!r}: expected 'adamw' or 'scaled_adam'")
    return MultiStepOptimizer(inner, sched, grad_clip=cfg.grad_clip, accum=cfg.grad_accum)


def draw_reject(y_lens, generator: Optional[torch.Generator] = None):
    """The random part of make_reject_y, on the CPU: pos uniform in
    [0, max(len - 1, 1)) and mode (True: repeat, False: drop) a fair coin,
    one each a row."""
    lens = torch.as_tensor(y_lens).cpu()
    high = torch.clamp_min(lens - 1, 1)
    pos = (torch.rand(lens.shape, generator=generator, dtype=torch.float64) * high).long()
    mode = torch.rand(lens.shape, generator=generator) < 0.5
    return pos, mode


def make_reject_y(y, y_lens, generator: Optional[torch.Generator] = None, *, pos=None, mode=None):
    """DPO rejected samples (ref AR/models/utils.py:244): in each row repeat
    the token at `pos` (the suffix shifts right) or drop it (the suffix shifts
    left), in the fixed buffer. `pos`/`mode` are drawn from `generator`
    unless given. -> (reject (B, T), reject_lens (B,))."""
    b, t = y.shape
    if pos is None:
        pos, mode = draw_reject(y_lens, generator)
    pos = torch.as_tensor(pos, device=y.device).long()[:, None]
    mode = torch.as_tensor(mode, device=y.device).bool()
    ar = torch.arange(t, device=y.device)[None, :]
    shift_right = torch.where(ar > pos, torch.roll(y, 1, dims=1), y)
    rep = torch.where(ar == pos + 1, y.gather(1, pos), shift_right)
    drop = torch.where(ar >= pos, torch.roll(y, -1, dims=1), y)
    reject = torch.where(mode[:, None], rep, drop)
    reject_lens = torch.where(mode, torch.clamp_max(y_lens + 1, t), torch.clamp_min(y_lens - 1, 1))
    return reject, reject_lens


def dpo_loss(chosen_logps, rejected_logps, beta: float = 0.2):
    """Reference-free DPO (ref utils.py:202, reference_free=True)."""
    return -F.logsigmoid(beta * (chosen_logps - rejected_logps)).mean()


def make_train_step(model: T2SDecoder, optimizer: MultiStepOptimizer, *, use_dpo: bool = False):
    """-> step(batch, generator=None, *, reject=None) -> metrics: one
    micro-step (forward, backward, optimizer.step()). `batch` holds tensors on
    the model's device (data.py `batch_to`); `reject` = (pos, mode) replaces the DPO
    draw. Metrics are detached tensors: loss and tokens of the global
    batch, acc of this rank's. With a process group each rank's DPO term (a
    batch mean) is scaled by 1/world (the cross-entropy is a sum) and the
    gradients are summed (parallel/sync.py)."""

    def step(batch: dict, generator: Optional[torch.Generator] = None, *, reject=None) -> dict:
        n = sync.world()
        args = (batch["phoneme_ids"], batch["phoneme_lens"])
        optimizer.zero_grad()
        loss, aux = t2s_loss(model, *args, batch["semantic_ids"], batch["semantic_lens"], batch["bert_features"])
        if use_dpo:
            pos, mode = reject if reject is not None else draw_reject(batch["semantic_lens"], generator)
            rej_y, rej_lens = make_reject_y(batch["semantic_ids"], batch["semantic_lens"], pos=pos, mode=mode)
            _, rej_aux = t2s_loss(model, *args, rej_y, rej_lens, batch["bert_features"])
            chosen = (aux["logp"] * aux["mask"]).sum(-1)
            rejected = (rej_aux["logp"] * rej_aux["mask"]).sum(-1)
            loss = loss + dpo_loss(chosen, rejected) / n
        loss.backward()
        sync.all_reduce_grads(optimizer.params)
        optimizer.step()
        return {"loss": sync.all_sum(loss), "acc": aux["acc"].detach(), "tokens": sync.all_sum(aux["tokens"])}

    return step
