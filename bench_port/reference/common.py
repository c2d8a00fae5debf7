"""Helpers and configuration types shared by the reference modules.

The configuration dataclasses hold the fields that the benchmark's
configuration files (`bench_port/configs/*.json`) state; they are the
reference's own, built from those files, never the program's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, or as it is when it is float64."""
    return x if x.dtype == torch.float64 else x.float()


@dataclass(frozen=True)
class MelConfig:
    sampling_rate: int = 32000
    n_fft: int = 2048
    win_size: int = 2048
    hop_size: int = 640
    num_mels: int = 128
    fmin: float = 0.0
    fmax: float | None = None


@dataclass(frozen=True)
class S1Config:
    vocab_size: int = 1025
    phoneme_vocab_size: int = 732
    embedding_dim: int = 512
    hidden_dim: int = 512
    num_heads: int = 16
    ffn_dim: int = 2048
    num_layers: int = 24
    eos_id: int = 1024
    bert_dim: int = 1024
    max_len: int = 4096
    semantic_frame_rate: int = 25


@dataclass(frozen=True)
class S2Config:
    version: str = "v2"
    spec_channels: int = 1025
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (10, 8, 2, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 8, 2, 2)
    gin_channels: int = 512
    mrte_hidden: int = 512
    ssl_dim: int = 768
    n_codes: int = 1024
    semantic_frame_rate: str = "25hz"
    sv_dim: int = 20480
    cfm_mel_channels: int = 100
    cfm_dit_depth: int = 22
    cfm_dit_dim: int = 1024
    cfm_dit_heads: int = 16

    @property
    def phoneme_vocab_size(self) -> int:
        return 732 if self.version != "v1" else 322

    @property
    def is_pro(self) -> bool:
        return self.version in ("v2Pro", "v2ProPlus")


def make(cls, fields: dict):
    """A configuration dataclass from a JSON object: known keys only, lists
    as tuples (nested ones too)."""
    names = {f.name for f in dataclasses.fields(cls)}

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return cls(**{k: tup(v) for k, v in fields.items() if k in names})
