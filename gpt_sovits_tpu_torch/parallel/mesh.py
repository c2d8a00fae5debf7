"""Device mesh and the tensor-parallel rules (port of
gpt_sovits_tpu/parallel/mesh.py).

A (data, model) mesh over the process group (`init_device_mesh`, dims named
"data" and "model"): data parallelism over batches, tensor parallelism of
the wide weights over "model".

The rule is the JAX package's `param_pspec`, which is shape-driven: a
kernel whose last flax axis (its output features) is >= 512 and even
shards that axis; a 2-D table with >= 4096 rows shards its rows; every
other parameter is replicated. In torch the output features lie in dim 0
of a Linear (and the DiT's QDense), Conv1d/Conv2d and fused `in_proj` weight, in dim 1 of a
ConvTranspose1d weight and in dim 1 (the width) of an embedding table;
`param_placement` reads each parameter in its layer's layout and gives its
DTensor placements on the mesh.

`shard_params` keeps each rank's shard of the sharded weights as a plain
parameter (so the trainers' optimizers and collectives see ordinary
tensors) and leaves a forward that runs on plain, replicated activations,
in megatron's column style: the owning layer computes its local output
channels (a grouped convolution on the matching slice of its input
channels), an autograd all-gather along the channel dim joins them, and
the bias, replicated, is added to the whole; in backward the gather takes
this rank's slice of the replicated gradient and the layer's input
gradient is summed over the model axis. A weight sharded elsewhere (a raw
parameter such as the VQ codebook, a table's rows) is gathered whole where
it is read. Differences by design: in JAX the compiler places the
collectives, and biases stay replicated there as here.
"""

from __future__ import annotations

import contextlib
import socket
import types
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.nn.utils import parametrize

from gpt_sovits_tpu_torch import resolve_device
from gpt_sovits_tpu_torch.models.dit import QDense
from gpt_sovits_tpu_torch.parallel import sync

TP_MIN_DIM = 512  # only kernels at least this wide shard
TABLE_MIN_ROWS = 4096  # 2-D tables with this many rows shard their rows
LINEAR = (nn.Linear, QDense)  # layers computing F.linear(x, weight, bias) (the DiT's float QDense)


def make_mesh(n_data: int = -1, n_model: int = 1, device=None) -> DeviceMesh:
    """A (data, model) mesh over every process of the group (n_data -1:
    the processes left over by n_model). Without a process group, a mesh of
    one process joins one of its own on a free local port."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_data not in (-1, 1) or n_model != 1:
            raise RuntimeError("make_mesh: join the process group first (parallel/launch.py init)")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if n_data == -1:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} over {world} processes")
    return init_device_mesh(dev.type, (n_data, n_model), mesh_dim_names=("data", "model"))


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Leading-axis data parallelism for input batches."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(), Replicate())


def shard_batch(batch, mesh: DeviceMesh):
    """This process's rows of a batch pytree (every tensor of rank >= 1
    split along its leading axis over "data", as batch_sharding says); 0-d
    tensors and non-tensors stay whole."""
    from torch.utils._pytree import tree_map

    n, i = mesh.size(0), mesh.get_local_rank("data")

    def rows(v):
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            if v.shape[0] % n:
                raise ValueError(f"shard_batch: {v.shape[0]} rows over {n} data ranks")
            return v.chunk(n)[i]
        return v

    return tree_map(rows, batch)


@contextlib.contextmanager
def data_parallel(mesh: DeviceMesh):
    """Within the block, parallel/sync.py's collectives (the trainers' loss
    scaling, gradient and metric sums) run over the mesh's "data" axis."""
    with sync.over(mesh.get_group("data")):
        yield


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


def _flax_order(owner, name: str, tensor) -> list[int]:
    """The torch dims of a parameter in the order of its JAX leaf's axes."""
    nd = tensor.ndim
    if (name == "weight" and isinstance(owner, LINEAR)) or name == "in_proj_weight":
        return [1, 0]  # (out, in) -> flax (in, out)
    if name == "weight" and isinstance(owner, (nn.Conv1d, nn.Conv2d)):
        return list(range(2, nd)) + [1, 0]  # (out, in/g, k...) -> (k..., in/g, out)
    if name == "weight" and isinstance(owner, nn.ConvTranspose1d):
        return list(range(2, nd)) + [0, 1]  # (in, out/g, k) -> (k, in, out)
    return list(range(nd))  # embedding tables and raw parameters: the flax layout


def _jax_axis(shape) -> int | None:
    """gpt_sovits_tpu/parallel/mesh.py param_pspec: the sharded axis, or None."""
    if len(shape) >= 2 and shape[-1] >= TP_MIN_DIM and shape[-1] % 2 == 0:
        return len(shape) - 1
    if len(shape) == 2 and shape[0] >= TABLE_MIN_ROWS:
        return 0
    return None


def param_placement(name: str, tensor: torch.Tensor, owner: nn.Module | None = None) -> tuple:
    """The DTensor placements on the (data, model) mesh of parameter `name`
    (its last part names it within `owner`, the module that holds it; None
    reads it in the flax layout): (Replicate(), Shard(dim)) for a sharded
    one, (Replicate(), Replicate()) otherwise."""
    order = _flax_order(owner, name.rsplit(".", 1)[-1], tensor)
    a = _jax_axis([tensor.shape[d] for d in order])
    return (Replicate(), Replicate()) if a is None else (Replicate(), Shard(order[a]))


def shard_dim(placements: tuple) -> int | None:
    p = placements[1]
    return p.dim if isinstance(p, Shard) else None


# ---------------------------------------------------------------------------
# the column style
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Axis:
    """The model axis of a mesh as this process sees it."""

    group: object
    rank: int
    n: int


class _Gather(torch.autograd.Function):
    """Forward: the ranks' parts concatenated along `dim`. Backward: this
    rank's part of the gradient, which every rank holds whole (the
    computation after the gather is replicated)."""

    @staticmethod
    def forward(ctx, x, dim: int, ax: _Axis):
        ctx.dim, ctx.ax = dim, ax
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ax.n)]
        dist.all_gather(parts, x, group=ax.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.ax.n, ctx.dim)[ctx.ax.rank].contiguous(), None, None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over the model
    axis (each rank's holds only its output channels' share)."""

    @staticmethod
    def forward(ctx, x, ax: _Axis):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.ax.group)
        return g, None


class _Whole(nn.Module):
    """A parametrization: the whole parameter, gathered from the ranks'
    shards where it is read."""

    def __init__(self, dim: int, ax: _Axis):
        super().__init__()
        self.dim, self.ax = dim, ax

    def forward(self, local):
        return _Gather.apply(local, self.dim, self.ax)


def _bias(y, bias, channel_dim: int):
    if bias is None:
        return y
    shape = [1] * y.ndim
    shape[channel_dim] = -1
    return y + bias.reshape(shape)


def _linear_forward(w_name: str, b_name: str, ax: _Axis):
    def forward(self, x):
        y = F.linear(_SumGrad.apply(x, ax), getattr(self, w_name))
        return _bias(_Gather.apply(y, y.ndim - 1, ax), getattr(self, b_name), -1)

    return forward


def _conv_forward(ax: _Axis):
    def forward(self, x):
        x = _SumGrad.apply(x, ax)
        groups = self.groups
        if groups > 1:  # the local output channels read only their groups' input channels
            x, groups = x.chunk(ax.n, 1)[ax.rank], groups // ax.n
        conv = F.conv1d if isinstance(self, nn.Conv1d) else F.conv2d
        y = conv(x, self.weight, None, self.stride, self.padding, self.dilation, groups)
        return _bias(_Gather.apply(y, 1, ax), self.bias, 1)

    return forward


def _conv_transpose_forward(ax: _Axis):
    def forward(self, x, output_size=None):
        y = F.conv_transpose1d(_SumGrad.apply(x, ax), self.weight, None, self.stride, self.padding,
                               self.output_padding, 1, self.dilation)
        return _bias(_Gather.apply(y, 1, ax), self.bias, 1)

    return forward


def _embedding_forward(ax: _Axis):
    def forward(self, idx):
        y = F.embedding(idx, self.weight, self.padding_idx, self.max_norm, self.norm_type, self.scale_grad_by_freq,
                        self.sparse)
        return _Gather.apply(y, y.ndim - 1, ax)

    return forward


def _column_style(owner: nn.Module, sharded: dict, ax: _Axis):
    """The forward that computes `owner`'s local output channels, where its
    sharded weights are exactly its output channels; else None."""
    if isinstance(owner, LINEAR) and sharded == {"weight": 0}:
        return _linear_forward("weight", "bias", ax)
    if sharded == {"in_proj_weight": 0} and hasattr(owner, "in_proj_bias"):
        return _linear_forward("in_proj_weight", "in_proj_bias", ax)
    if (isinstance(owner, (nn.Conv1d, nn.Conv2d)) and sharded == {"weight": 0} and owner.padding_mode == "zeros"
            and (owner.groups == 1 or owner.groups % ax.n == 0)):
        return _conv_forward(ax)
    if isinstance(owner, nn.ConvTranspose1d) and sharded == {"weight": 1} and owner.groups == 1:
        return _conv_transpose_forward(ax)
    if isinstance(owner, nn.Embedding) and sharded == {"weight": 1}:
        return _embedding_forward(ax)
    return None


def shard_params(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard `module`'s parameters over the mesh's "model" axis by
    param_placement, in place: each sharded parameter becomes this rank's
    shard (an nn.Parameter marked with `tp_dim` and `tp_group`), and each
    owning layer gets the column style (or, where that does not apply, its
    shards are gathered where they are read). -> module."""
    ax = _Axis(mesh.get_group("model"), mesh.get_local_rank("model"), mesh.size(1))
    for owner in list(module.modules()):
        sharded = {}
        for name, p in list(owner.named_parameters(recurse=False)):
            d = shard_dim(param_placement(name, p, owner))
            if d is None:
                continue
            if p.shape[d] % ax.n:
                raise ValueError(f"shard_params: {name} {tuple(p.shape)}: dim {d} over {ax.n} model ranks")
            local = nn.Parameter(p.detach().chunk(ax.n, d)[ax.rank].clone(), requires_grad=p.requires_grad)
            local.tp_dim, local.tp_group = d, ax.group
            setattr(owner, name, local)
            sharded[name] = d
        if not sharded:
            continue
        forward = _column_style(owner, sharded, ax)
        if forward is not None:
            owner.forward = types.MethodType(forward, owner)
        else:
            for name, d in sharded.items():
                parametrize.register_parametrization(owner, name, _Whole(d, ax), unsafe=True)
    return module


def gather_params(module: nn.Module, grads: bool = False) -> dict:
    """The whole value (or, with grads, the whole gradient, None where
    there is none) of every parameter of a sharded module, by its name in
    the unsharded module, on every rank."""
    out = {}
    for name, p in module.named_parameters():
        name = name.replace("parametrizations.", "").removesuffix(".original")
        v = p.grad if grads else p.detach()
        if v is not None and hasattr(p, "tp_dim"):
            parts = [torch.empty_like(v) for _ in range(dist.get_world_size(p.tp_group))]
            dist.all_gather(parts, v.contiguous(), group=p.tp_group)
            v = torch.cat(parts, p.tp_dim)
        out[name] = None if v is None else v.clone()
    return out
