"""Rounding to lower precisions, for the control runs: what a computation
in that precision would have kept of each value."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fake_quant(x: torch.Tensor, bits: int, dim: int = -1) -> torch.Tensor:
    """x rounded to a symmetric signed grid of `bits` bits, one scale per
    slice along every axis but `dim` (the max |x| of the slice)."""
    top = 2 ** (bits - 1) - 1
    s = torch.clamp_min(x.abs().amax(dim=dim, keepdim=True) / top, 1e-12)
    return torch.clamp(torch.round(x / s), -top, top) * s


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor."""
    s = torch.clamp_min(x.abs().amax() / E4M3_MAX, 1e-30)
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s
