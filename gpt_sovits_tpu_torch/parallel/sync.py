"""Collectives of a data-parallel training step (the reference's DDP
all-reduce, s2_train.py:58-85; the JAX package's compiler-inserted psum).

The JAX step sees the global batch. Here each rank holds its share of it,
scales its loss so that the ranks' losses add up to the global loss (a
batch mean by 1/world, a sum as it is, a masked mean by the global mask
count), and the gradients are then summed over the ranks: every rank
applies the global batch's gradient. Without a process group (or with one
of one process) every function here is the identity, so a world of one
runs exactly as without data parallelism.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, as a new tensor (detached)."""
    out = t.detach().clone()
    if world() > 1:
        dist.all_reduce(out)
    return out


def from_rank0(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's value of `t` on every rank (a batch-wide draw)."""
    out = t.detach().clone()
    if world() > 1:
        dist.broadcast(out, src=0)
    return out


@torch.no_grad()
def all_reduce_grads(params) -> None:
    """Sum every parameter's `.grad` over the ranks in place, in one
    collective. Parameters without a gradient (frozen) are skipped: every
    rank runs the same code on the same model, so they are the same set."""
    if world() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()
