"""BERT text-feature encoder (chinese-roberta-wwm-ext-large).

Port of gpt_sovits_tpu/models/bert.py. The reference takes phone-level text
features from the third-to-last hidden layer of chinese-roberta-wwm-ext-large,
repeated per phone by word2ph (TTS_infer_pack/TextPreprocessor.py:191-204).
A post-LN BERT encoder: embeddings (word + position + token type) and a
LayerNorm, then `num_layers` layers of self-attention and an exact-GELU FFN,
each closed by a residual LayerNorm (eps 1e-12); padded keys are masked with
-inf, as the JAX module does.

`BertEncoder.state_dict()` has the names of the HF `BertModel` without its
pooler (`embeddings.*`, `encoder.layer.{i}.*`), so a chinese-roberta
`pytorch_model.bin` (its `bert.` prefix removed) loads with strict=True.
The encoder runs in f32 on the card as on the CPU, as the JAX pipeline runs
it; `resolve_device` keeps TF32 off for f32 matmuls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21128
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)[None] \
            + self.token_type_embeddings(token_type_ids)
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)


class _DenseNorm(nn.Module):
    """dense -> dropout (none at inference) -> LayerNorm(x + residual)."""

    def __init__(self, d_in: int, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(d_in, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _DenseNorm(c.hidden_size, c)


class _Intermediate(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.cfg = c
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _DenseNorm(c.intermediate_size, c)

    def forward(self, x, key_bias):
        """x (B, T, D); key_bias (B, 1, 1, T): 0 on real keys, -inf on pads."""
        b, t, _ = x.shape
        h, dk = self.cfg.num_heads, self.cfg.hidden_size // self.cfg.num_heads
        sa = self.attention.self

        def heads(lin):
            return lin(x).reshape(b, t, h, dk).transpose(1, 2)

        q, k, v = heads(sa.query), heads(sa.key), heads(sa.value)
        scores = torch.matmul(q / math.sqrt(dk), k.transpose(-1, -2)) + key_bias
        attn = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, t, -1)
        x = self.attention.output(attn, x)
        ff = F.gelu(self.intermediate.dense(x), approximate="none")
        return self.output(ff, x)


class _Layers(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c) for _ in range(c.num_layers))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Layers(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> list[torch.Tensor]:
        """-> hidden states per layer (num_layers + 1, embeddings first), each
        (B, T, hidden)."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.bool)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        key_bias = torch.zeros(attention_mask.shape, dtype=torch.float32, device=input_ids.device)
        key_bias = key_bias.masked_fill(~attention_mask.bool(), float("-inf"))[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids)
        hidden = [x]
        for layer in self.encoder.layer:
            x = layer(x, key_bias)
            hidden.append(x)
        return hidden


def phone_level_features(char_hidden: torch.Tensor, word2ph: Sequence[int]) -> torch.Tensor:
    """Repeat char-level features per phone (ref TextPreprocessor.py:196-200).

    char_hidden (T_char, H); word2ph: phones per char -> (sum(word2ph), H)."""
    reps = torch.as_tensor(list(word2ph), dtype=torch.int64, device=char_hidden.device)
    return torch.repeat_interleave(char_hidden, reps, dim=0)
