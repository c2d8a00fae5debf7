"""Seeded random weights, made on the module's device in a few large calls.

Every parameter of a module becomes a view of one flat float32 buffer that a
`torch.Generator` on the module's device fills with a single `randn` call;
the buffer is then scaled and shifted by per-parameter factors in two more
elementwise calls. Parameters are taken in the order of their sorted names,
so two modules with the same parameter names and shapes (the program's and
the reference's) get the same values from the same seed and stream name.

The scale follows PyTorch's default initialisation in its standard
deviation: a matrix or kernel gets std 1/sqrt(3 * fan_in), a 1-D or scalar
gain (`weight`, `gamma`, `alpha`) the constant 1, any other vector (biases)
std 0.02. A configuration file's `weights` may name rows drawn as zeros
(`zero_rows`) and parameters whose spread is multiplied (`gains`).
"""

from __future__ import annotations

import hashlib
import math

import torch

ONES = ("weight", "gamma", "alpha")  # 1-D and scalar gains: drawn as the constant 1


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of one run seed."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _factors(name: str, p: torch.Tensor) -> tuple[float, float]:
    """(std, mean) of one parameter's values."""
    last = name.rsplit(".", 1)[-1]
    if p.dim() >= 2:
        return 1.0 / math.sqrt(3.0 * max(1, p[0].numel())), 0.0
    if last in ONES:
        return 0.0, 1.0
    return 0.02, 0.0


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int, stream: str, spec: dict | None = None) -> int:
    """Make every parameter of `module` a view of one seeded flat buffer on
    the module's device. `spec` (a configuration's `weights`) may map, under
    the stream's name, `zero_rows` (parameter -> row indices drawn as zeros)
    and `gains` (parameter -> factor on its spread). Returns the number of
    values drawn."""
    named = sorted(module.named_parameters(), key=lambda kv: kv[0])
    if not named:
        return 0
    dev = named[0][1].device
    sizes = [p.numel() for _, p in named]
    total = sum(sizes)
    gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, stream))
    flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    zero_rows = (spec or {}).get("zero_rows", {}).get(stream, {})
    gains = (spec or {}).get("gains", {}).get(stream, {})
    std, mean = zip(*(_factors(n, p) for n, p in named))
    std = [s * gains.get(n, 1.0) for s, (n, _) in zip(std, named)]
    counts = torch.tensor(sizes, device=dev)
    flat.mul_(torch.repeat_interleave(torch.tensor(std, device=dev), counts))
    flat.add_(torch.repeat_interleave(torch.tensor(mean, device=dev), counts))
    off = 0
    for (name, p), n in zip(named, sizes):
        view = flat[off : off + n].view(p.shape)
        for row in zero_rows.get(name, ()):
            view[row] = 0.0
        p.data = view
        off += n
    return total
