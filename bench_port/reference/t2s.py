"""S1, the autoregressive text -> semantic transformer, as a full-sequence
forward (a frozen copy of the plain float composition of
gpt_sovits_tpu_torch/models/t2s.py for the benchmark's reference).

No cache and no decode loop: the logits that predict every generated token
come from one causal pass over [text, prompt + served tokens], which is what
the program's prefill and cached decode steps must agree with. Parameter
names are the reference project's (`h.layers.{i}.self_attn.in_proj_weight`,
...).

`kv_bits` (None in the reference) rounds each token's K and V to a signed
integer grid of that many bits per token and head group, as an int-KV cache
stores them: the control run's lower precision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port.reference.common import S1Config
from bench_port.reference.precision import fake_quant

LN_EPS = 1e-6


def sine_position_table(max_len: int, dim: int) -> np.ndarray:
    pe = np.zeros((max_len, dim), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class SelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        return F.linear(x, self.in_proj_weight, self.in_proj_bias)


class TransformerLayer(nn.Module):
    """Post-LN: x = LN1(x + attn(x)); x = LN2(x + relu-MLP(x))."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.kv_bits = None
        self.self_attn = SelfAttention(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, attn_bias):
        b, t, d = x.shape
        h = self.num_heads
        q, k, v = self.self_attn(x).split(d, dim=-1)
        if self.kv_bits:
            k, v = fake_quant(k, self.kv_bits), fake_quant(v, self.kv_bits)
        q, k, v = (z.reshape(b, t, h, d // h) for z in (q, k, v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d // h) + attn_bias
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v).reshape(b, t, d)
        x = self.norm1(x + self.self_attn.out_proj(out))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _WordEmbedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.word_embeddings = nn.Embedding(n, dim)


class _PositionAlpha(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(()))


class T2SDecoder(nn.Module):
    def __init__(self, cfg: S1Config):
        super().__init__()
        c = self.cfg = cfg
        self.ar_text_embedding = _WordEmbedding(c.phoneme_vocab_size, c.embedding_dim)
        self.ar_audio_embedding = _WordEmbedding(c.vocab_size, c.embedding_dim)
        self.bert_proj = nn.Linear(c.bert_dim, c.embedding_dim)
        self.ar_text_position = _PositionAlpha()
        self.ar_audio_position = _PositionAlpha()
        self.h = _Stack([TransformerLayer(c.hidden_dim, c.num_heads, c.ffn_dim) for _ in range(c.num_layers)])
        self.ar_predict_layer = nn.Linear(c.hidden_dim, c.vocab_size, bias=False)
        self.register_buffer("pe", torch.from_numpy(sine_position_table(c.max_len, c.embedding_dim)), persistent=False)

    def _pe(self, positions):
        return self.pe[torch.clamp(positions, max=self.cfg.max_len - 1)]

    def logits(self, phones: torch.Tensor, semantic: torch.Tensor) -> torch.Tensor:
        """phones (Tx,) ids, semantic (Ty,) = prompt + served tokens -> the
        logits (Ty, vocab) at every audio position: row j predicts
        semantic[j + 1]. BERT features are zeros (the traffic is English)."""
        dev = phones.device
        tx, ty = phones.shape[0], semantic.shape[0]
        x = self.ar_text_embedding.word_embeddings(phones) + self.bert_proj.bias
        x = x + self.ar_text_position.alpha * self._pe(torch.arange(tx, device=dev))
        y = self.ar_audio_embedding.word_embeddings(semantic)
        y = y + self.ar_audio_position.alpha * self._pe(torch.arange(ty, device=dev))
        t = tx + ty
        allow = torch.ones((t, t), dtype=torch.bool, device=dev)
        allow[:tx, tx:] = False
        allow[tx:, tx:] = torch.tril(torch.ones((ty, ty), dtype=torch.bool, device=dev))
        bias = torch.where(allow, 0.0, float("-inf"))[None, None]
        h = torch.cat([x, y])[None]
        for layer in self.h.layers:
            h = layer(h, bias)
        return self.ar_predict_layer(h[0, tx:])
