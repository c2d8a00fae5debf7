"""CNHuBERT SSL feature encoder (port of gpt_sovits_tpu/models/hubert.py).

HuBERT-base layout (HF transformers HubertModel, group-norm first conv,
post-LN encoder): 16 kHz waveform -> 768-d hidden states at 50 Hz.
Parameter names are HF's, so `weights.hubert_from_jax` and an HF state dict
(with its positional-conv weight norm folded) load with strict=True.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class HubertConfig:
    conv_dim: int = 512
    conv_kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5


class _ConvLayer(nn.Module):
    def __init__(self, cin, cout, k, s, group_norm: bool, eps: float):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=s, bias=False)
        if group_norm:
            self.layer_norm = nn.GroupNorm(cout, cout, eps=eps)


class _FeatureExtractor(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            _ConvLayer(1 if i == 0 else c.conv_dim, c.conv_dim, k, s, i == 0, c.layer_norm_eps)
            for i, (k, s) in enumerate(zip(c.conv_kernels, c.conv_strides))
        )

    def forward(self, wav):
        x = wav[:, None, :]
        for i, layer in enumerate(self.conv_layers):
            x = layer.conv(x)
            if i == 0:
                x = layer.layer_norm(x)
            x = F.gelu(x)
        return x.transpose(1, 2)  # (B, T, conv_dim)


class _FeatureProjection(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c.conv_dim, eps=c.layer_norm_eps)
        self.projection = nn.Linear(c.conv_dim, c.hidden_size)


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _FeedForward(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, f)
        self.output_dense = nn.Linear(f, d)


class _EncoderLayer(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.num_heads = c.num_heads
        self.attention = _Attention(c.hidden_size)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = _FeedForward(c.hidden_size, c.intermediate_size)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x):
        b, t, d = x.shape
        h = self.num_heads
        dk = d // h
        a = self.attention
        q = a.q_proj(x).reshape(b, t, h, dk).transpose(1, 2) / np.sqrt(dk)
        k = a.k_proj(x).reshape(b, t, h, dk).transpose(1, 2)
        v = a.v_proj(x).reshape(b, t, h, dk).transpose(1, 2)
        probs = torch.softmax(q @ k.transpose(2, 3), dim=-1)
        attn = a.out_proj((probs @ v).transpose(1, 2).reshape(b, t, d))
        x = self.layer_norm(x + attn)
        ff = self.feed_forward.output_dense(F.gelu(self.feed_forward.intermediate_dense(x)))
        return self.final_layer_norm(x + ff)


class _PosConv(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.conv = nn.Conv1d(
            c.hidden_size, c.hidden_size, c.pos_conv_kernel, padding=c.pos_conv_kernel // 2, groups=c.pos_conv_groups
        )


class _Encoder(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.pos_conv_embed = _PosConv(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(_EncoderLayer(c) for _ in range(c.num_layers))


class HubertEncoder(nn.Module):
    def __init__(self, cfg: HubertConfig = HubertConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, wav):
        """wav (B, L) 16 kHz float in [-1, 1] -> (B, T, hidden) at 50 Hz."""
        c = self.cfg
        x = self.feature_extractor(wav)
        x = self.feature_projection.projection(self.feature_projection.layer_norm(x))
        pos = self.encoder.pos_conv_embed.conv(x.transpose(1, 2))
        if c.pos_conv_kernel % 2 == 0:
            pos = pos[:, :, :-1]
        x = x + F.gelu(pos).transpose(1, 2)
        x = self.encoder.layer_norm(x)
        for layer in self.encoder.layers:
            x = layer(x)
        return x
