"""ScaledAdam (k2/icefall) as a `torch.optim.Optimizer` (port of
gpt_sovits_tpu/train/scaled_adam.py, the reference's AR/modules/optim.py).

  * a tensor's update is proportional to its RMS: lr * rms(p) * Adam
    direction of the gradient, plus a scale channel (the projection of the
    gradient on the parameter direction) with its own Adam moments at
    lr * scale_lr_scale;
  * scalars and vectors (ndim <= 1) take plain Adam at the base lr;
  * median clipping (optim.py:279-358 `_get_clipping_scale`): the
    RMS-weighted gradient norm of each step goes into a ring of
    `clipping_update_period` entries; every period the threshold becomes
    clipping_scale x median(ring), and gradients scale by
    min(1, threshold / norm) once a full period has been seen.

The ring, the threshold and the step count are the optimizer's own state
(`state["clip"]`); the per-tensor moments are each parameter's state.
"""

from __future__ import annotations

import torch

from gpt_sovits_tpu_torch.train.optim import MultiStepOptimizer


class ScaledAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 0.025, *, betas=(0.9, 0.98), eps: float = 1e-8,
                 param_rms_min: float = 1e-5, scale_lr_scale: float = 0.1,
                 clipping_scale: float | None = 2.0, clipping_update_period: int = 100):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, param_rms_min=param_rms_min,
                        scale_lr_scale=scale_lr_scale)
        super().__init__(params, defaults)
        self.clipping_scale = clipping_scale
        self.period = clipping_update_period

    def _clip_state(self, device):
        if "clip" not in self.state:
            self.state["clip"] = {
                "count": 0,
                "norm_buf": torch.zeros(self.period, device=device),
                "threshold": torch.zeros((), device=device),
            }
        return self.state["clip"]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        items = [(p, g) for g in self.param_groups for p in g["params"] if p.grad is not None]
        if not items:
            return loss
        clip = self._clip_state(items[0][0].device)
        step = clip["count"]  # 0-based, the reference's `step`
        factor = None
        if self.clipping_scale is not None:
            sq = []
            for group in self.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    g = p.grad.float()
                    if p.ndim <= 1:
                        sq.append((g * g).sum())
                    else:
                        rms = torch.clamp_min(torch.sqrt(torch.mean(p * p)), group["param_rms_min"])
                        sq.append(((g * rms) ** 2).sum())
            tot_norm = torch.sqrt(torch.stack(sq).sum())
            if step > 0:  # the reference returns early at step 0
                clip["norm_buf"][step % self.period] = tot_norm
                if step % self.period == 0:
                    # jnp.median: an even ring's median is the mean of its two middle entries
                    clip["threshold"] = self.clipping_scale * torch.quantile(clip["norm_buf"], 0.5)
            if step >= self.period:
                factor = torch.clamp(clip["threshold"] / (tot_norm + 1e-20), max=1.0)
        clip["count"] = count = step + 1

        for group in self.param_groups:
            lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
            rms_min, s_lr = group["param_rms_min"], group["scale_lr_scale"]
            bc1, bc2 = 1 - b1**count, 1 - b2**count
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if factor is None else p.grad * factor
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros_like(p)
                    st["v"] = torch.zeros_like(p)
                    st["scale_m"] = torch.zeros((), device=p.device)
                    st["scale_v"] = torch.zeros((), device=p.device)
                m, v = st["m"], st["v"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).add_(g * g, alpha=1 - b2)
                direction = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if p.ndim <= 1:
                    p.add_(direction, alpha=-lr)
                    continue
                rms = torch.clamp_min(torch.sqrt(torch.mean(p * p)), rms_min)
                sg = torch.sum(g * p) / rms
                st["scale_m"] = b1 * st["scale_m"] + (1 - b1) * sg
                st["scale_v"] = b2 * st["scale_v"] + (1 - b2) * sg * sg
                s_dir = (st["scale_m"] / bc1) / (torch.sqrt(st["scale_v"] / bc2) + eps)
                delta = -lr * rms * direction - (lr * s_lr) * s_dir * (p / rms)
                p.add_(delta)
        return loss


def scaled_adam_with_clip(params, learning_rate: float = 0.025, *, grad_clip: float = 1.0, **kw):
    """chain(clip_by_global_norm(grad_clip), ScaledAdam): the median clip is
    ScaledAdam's own; the global-norm clip is a hard bound on top."""
    return MultiStepOptimizer(ScaledAdam(params, learning_rate, **kw), lambda _: learning_rate, grad_clip=grad_clip)
