"""PyTorch/CUDA port of the gpt_sovits_tpu JAX package.

The JAX package beside this one is the reference; this package imports
nothing of it (nor jax/flax). Entry points run on the GPU unless the caller
passes ``device="cpu"``; the hand-written CUDA kernels live in ``csrc/`` and
are built with nvcc on first use (``ops/build.py``).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA, and raises when no card is present (no silent
    CPU fallback). A CUDA device also pins the numerics: float32 matmuls and
    cuDNN convolutions run in full float32, not TF32 (cuDNN's default is TF32,
    which keeps ~3 decimal digits and would put the f32 vocoder path off the
    reference)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
