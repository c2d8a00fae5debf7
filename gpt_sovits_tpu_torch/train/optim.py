"""The optax wrappers the trainers use, over a `torch.optim.Optimizer`:
`optax.clip_by_global_norm` and `optax.MultiSteps`, with the learning rate
read from a schedule of the update count (optax's `scale_by_schedule`;
S1's warm-up, S2's `exponential_decay`)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float, groups: Optional[list] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient scales by
    max_norm / norm when the global L2 norm reaches max_norm. `groups`
    gives, for each gradient, the process group over whose ranks it is
    sharded (parallel/mesh.py `tp_group`) or None: a sharded gradient's
    squares are summed over its group. -> the norm."""
    groups = groups or [None] * len(grads)
    sq = {}
    for g, grp in zip(grads, groups):
        sq[grp] = sq.get(grp, 0.0) + (g.float() ** 2).sum()
    for grp, s in sq.items():
        if grp is not None:
            torch.distributed.all_reduce(s, group=grp)
    norm = torch.sqrt(sum(sq.values()))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class MultiStepOptimizer:
    """optax.MultiSteps(chain(clip_by_global_norm(grad_clip), inner), accum),
    or no clip where grad_clip is None.

    `step()` takes the gradients of one micro-step (each parameter's
    `.grad`; a missing one counts as zeros). With accum > 1 they join a
    running mean (optax's `acc + (g - acc) / (n + 1)`), and every accum-th
    call the mean is clipped and handed to `inner`: the clip acts on the
    mean, not on each micro-gradient. A group's learning rate is
    `schedule(updates)` times the group's "lr_scale" (1 where unset), where
    `updates` counts inner updates, not micro-steps, as MultiSteps advances
    its inner schedule."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Callable[[int], float], *,
                 grad_clip: Optional[float], accum: int = 1):
        self.inner = inner
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.accum = accum
        self.params = [p for g in inner.param_groups for p in g["params"]]
        self.mini_step = 0
        self.updates = 0
        self.acc: Optional[list] = None

    def group_lrs(self, updates: int) -> list[float]:
        lr = float(self.schedule(updates))
        return [lr * g.get("lr_scale", 1.0) for g in self.inner.param_groups]

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> bool:
        """-> True when this call updated the parameters."""
        if self.accum > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for p, a in zip(self.params, self.acc):
                a.add_(((p.grad if p.grad is not None else 0.0) - a) / (n + 1))
            self.mini_step = (n + 1) % self.accum
            if self.mini_step:
                return False
            for p, a in zip(self.params, self.acc):
                p.grad = a
            self.acc = None
        held = [p for p in self.params if p.grad is not None]
        if held and self.grad_clip is not None:
            clip_by_global_norm_([p.grad for p in held], self.grad_clip, [getattr(p, "tp_group", None) for p in held])
        for group, lr in zip(self.inner.param_groups, self.group_lrs(self.updates)):
            group["lr"] = lr
        self.inner.step()
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step, "updates": self.updates,
                "acc": None if self.acc is None else [a.clone() for a in self.acc]}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd["inner"])
        self.mini_step, self.updates = sd["mini_step"], sd["updates"]
        self.acc = None if sd["acc"] is None else [a.to(p.device) for a, p in zip(sd["acc"], self.params)]
