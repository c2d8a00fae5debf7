"""The published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
sparsity, at its 700 W power limit), and the least time a piece of work
needs on it."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def compute_s(ops: float, precision: str) -> float:
    return ops / PEAK_OPS[precision]


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The larger of the operations at the precision's peak and the bytes
    at the memory's bandwidth."""
    return max(compute_s(ops, precision), nbytes / HBM_BYTES_S)
