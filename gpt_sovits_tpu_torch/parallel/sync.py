"""Collectives of a data-parallel training step (the reference's DDP
all-reduce, s2_train.py:58-85; the JAX package's compiler-inserted psum).

The JAX step sees the global batch. Here each rank holds its share of it,
scales its loss so that the ranks' losses add up to the global loss (a
batch mean by 1/world, a sum as it is, a masked mean by the global mask
count), and the gradients are then summed over the ranks: every rank
applies the global batch's gradient. Without a process group (or with one
of one process) every function here is the identity, so a world of one
runs exactly as without data parallelism. The group is the default one, or
within `over(group)` the given one (a mesh's "data" axis, parallel/mesh.py
`data_parallel`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_GROUP: list = [None]  # the data-parallel group of `over`; None: the default group


@contextlib.contextmanager
def over(group):
    """Within the block, the collectives here run over `group`."""
    saved, _GROUP[0] = _GROUP[0], group
    try:
        yield
    finally:
        _GROUP[0] = saved


def world() -> int:
    """The number of processes in the data-parallel group (1 without one)."""
    return dist.get_world_size(_GROUP[0]) if dist.is_available() and dist.is_initialized() else 1


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, as a new tensor (detached)."""
    out = t.detach().clone()
    if world() > 1:
        dist.all_reduce(out, group=_GROUP[0])
    return out


def from_rank0(t: torch.Tensor) -> torch.Tensor:
    """The group's first rank's value of `t` on every rank (a batch-wide draw)."""
    out = t.detach().clone()
    if world() > 1:
        src = 0 if _GROUP[0] is None else dist.get_global_rank(_GROUP[0], 0)
        dist.broadcast(out, src=src, group=_GROUP[0])
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
    dist.all_reduce(flat, group=_GROUP[0])
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()
