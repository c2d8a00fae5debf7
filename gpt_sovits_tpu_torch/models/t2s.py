"""S1: autoregressive text->semantic transformer (port of
gpt_sovits_tpu/models/t2s.py).

Module and parameter names follow the reference's state dict
(`h.layers.{i}.self_attn.in_proj_weight`, `ar_predict_layer.weight`, ...),
so a reference checkpoint and `weights.s1_from_jax` load with strict=True.

Decoding (`generate`) is a Python loop over a preallocated static-shape
cache. Two step implementations, as in the JAX package:
  * the plain step (`T2SDecoder.decode_step`): f32, separate K/V caches
    (L, B, T, H, Dh), validity mask INCLUDING the slot being written;
  * the fused step (`use_fused_kernel=True`): ops/decode_step.py, i.e. the
    CUDA kernels on a card, with a combined K||V cache in bf16 or int8
    padded to a multiple of 512 slots, and a mask EXCLUDING the slot being
    written.
Finished rows are masked, not evicted; whether every row is done is read
on the host only every few steps (tokens after EOS are masked, so the
output is identical).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gpt_sovits_tpu_torch import at_least_f32
from gpt_sovits_tpu_torch.utils.config import S1Config

EOS_MASK_WARMUP_STEPS = 11  # ref t2s_model.py:889 — no EOS before 0.4 s
STOP_CHECK_EVERY = 8  # host reads of all(done) in generate()
# the JAX TransformerLayer uses flax's default LayerNorm epsilon; the fused
# decode kernel uses 1e-5 (see ops/decode_step.py)
LN_EPS = 1e-6


def sine_position_table(max_len: int, dim: int) -> np.ndarray:
    """Sinusoidal position table, matches AR/modules/embedding.py:52-62."""
    pe = np.zeros((max_len, dim), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameter layout (in_proj_*, out_proj);
    calling it gives the fused q||k||v projection."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        return F.linear(x, self.in_proj_weight, self.in_proj_bias)


class TransformerLayer(nn.Module):
    """Post-LN encoder layer: x = LN1(x + attn(x)); x = LN2(x + relu-MLP(x))."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.self_attn = SelfAttention(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def _mlp(self, x):
        x = self.norm2(x + self.linear2(F.relu(self.linear1(x))))
        return x

    def forward(self, x, attn_bias):
        """Full-sequence attention; attn_bias (B, 1|H, T, T) additive.
        Returns (x, k, v) with k, v (B, T, H, Dh)."""
        b, t, d = x.shape
        h = self.num_heads
        q, k, v = (z.reshape(b, t, h, d // h) for z in self.self_attn(x).split(d, dim=-1))
        scale = 1.0 / np.sqrt(d // h)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + attn_bias
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
        x = self.norm1(x + self.self_attn.out_proj(out))
        return self._mlp(x), k, v

    def decode(self, x, k_cache, v_cache, valid_mask, write_idx):
        """Single-token step. x (B,1,D); caches (B,T,H,Dh), written in place;
        valid_mask (B,T) bool including the written slot. write_idx: an int,
        every row's slot (generate), or a (B,) integer tensor or sequence, row
        i's slot write_idx[i] (rows at independent steps, as continuous
        batching runs them)."""
        b, _, d = x.shape
        h = self.num_heads
        dh = d // h
        q, k_new, v_new = self.self_attn(x).split(d, dim=-1)
        if not isinstance(write_idx, int) and torch.as_tensor(write_idx).ndim == 1:
            rows = torch.arange(b, device=k_cache.device)
            idx = torch.as_tensor(write_idx, device=k_cache.device)
            k_cache[rows, idx] = k_new.reshape(b, h, dh)
            v_cache[rows, idx] = v_new.reshape(b, h, dh)
        else:
            k_cache[:, write_idx] = k_new.reshape(b, h, dh)
            v_cache[:, write_idx] = v_new.reshape(b, h, dh)
        return self._attend(x, q, k_cache, v_cache, valid_mask)

    def decode_functional(self, x, k_cache, v_cache, valid_mask, write_idx):
        """`decode` without side effects, as the JAX layer's: write_idx a 0-d
        or (B,) integer tensor, clamped into the cache as a dynamic update
        clamps it -> (x, new k_cache, new v_cache). The new K/V go in by a
        select over the slots, so no value is read to the host and no input
        is written (what torch.export needs)."""
        b, _, d = x.shape
        t, h = k_cache.shape[1], self.num_heads
        q, k_new, v_new = self.self_attn(x).split(d, dim=-1)
        slot = torch.clamp(write_idx, 0, t - 1).reshape(-1, 1)  # (1 | B, 1)
        at = (torch.arange(t, device=k_cache.device)[None, :] == slot)[:, :, None, None]
        k_cache = torch.where(at, k_new.reshape(b, 1, h, d // h), k_cache)
        v_cache = torch.where(at, v_new.reshape(b, 1, h, d // h), v_cache)
        return self._attend(x, q, k_cache, v_cache, valid_mask), k_cache, v_cache

    def _attend(self, x, q, k_cache, v_cache, valid_mask):
        """The step after the cache write: the query over the valid slots,
        then the residual, LN and MLP."""
        b, _, d = x.shape
        h = self.num_heads
        dh = d // h
        scale = 1.0 / np.sqrt(dh)
        scores = torch.einsum("bhd,bkhd->bhk", q.reshape(b, h, dh), k_cache) * scale
        scores = scores.masked_fill(~valid_mask[:, None, :], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhk,bkhd->bhd", probs, v_cache).reshape(b, 1, d)
        x = self.norm1(x + self.self_attn.out_proj(out))
        return self._mlp(x)


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
    """The S1 model."""

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

    def embed_text(self, phoneme_ids, bert_features, positions):
        """(B,Tx) ids + (B,Tx,bert_dim) + (B,Tx) position idx -> (B,Tx,D)."""
        x = self.ar_text_embedding.word_embeddings(phoneme_ids) + self.bert_proj(bert_features)
        return x + self.ar_text_position.alpha * self._pe(positions)

    def embed_audio(self, semantic_ids, positions):
        y = self.ar_audio_embedding.word_embeddings(semantic_ids)
        return y + self.ar_audio_position.alpha * self._pe(positions)

    def _pe(self, positions):
        # positions past the table read its last row, as a JAX gather clamps
        return self.pe[torch.clamp(positions, max=self.cfg.max_len - 1)]

    def forward(self, xy_emb, attn_bias):
        """Full-sequence forward -> logits (B, T, vocab)."""
        x = xy_emb
        for layer in self.h.layers:
            x, _, _ = layer(x, attn_bias)
        return self.ar_predict_layer(x)

    def prefill(self, xy_emb, attn_bias):
        """-> (logits at the last slot (B,V), k (L,B,T,H,Dh), v (L,B,T,H,Dh))."""
        x = xy_emb
        ks, vs = [], []
        for layer in self.h.layers:
            x, k, v = layer(x, attn_bias)
            ks.append(k)
            vs.append(v)
        return self.ar_predict_layer(x[:, -1]), torch.stack(ks), torch.stack(vs)

    def decode_step(self, tok_emb, k_caches, v_caches, valid_mask, write_idx):
        """One step across all layers; caches (L,B,T,H,Dh) updated in place
        at write_idx, an int or one slot a row (TransformerLayer.decode)."""
        x = tok_emb
        for i, layer in enumerate(self.h.layers):
            x = layer.decode(x, k_caches[i], v_caches[i], valid_mask, write_idx)
        return self.ar_predict_layer(x[:, 0])

    def decode_step_functional(self, tok_emb, k_caches, v_caches, valid_mask, write_idx):
        """`decode_step` as the JAX package's: write_idx a 0-d or (B,)
        integer tensor, the input caches untouched -> (logits (B,V), new
        k_caches, new v_caches (L,B,T,H,Dh)). What utils/export.py exports."""
        x = tok_emb
        new_ks, new_vs = [], []
        for i, layer in enumerate(self.h.layers):
            x, k, v = layer.decode_functional(x, k_caches[i], v_caches[i], valid_mask, write_idx)
            new_ks.append(k)
            new_vs.append(v)
        return self.ar_predict_layer(x[:, 0]), torch.stack(new_ks), torch.stack(new_vs)


def build_prefix_attn_bias(x_valid, y_valid):
    """Additive bias (B, 1, T, T): text rows attend to all valid text; audio
    rows attend to valid text + causal valid audio; every row sees itself."""
    b, tx = x_valid.shape
    ty = y_valid.shape[1]
    t = tx + ty
    key_valid = torch.cat([x_valid, y_valid], dim=1)
    allow = key_valid[:, None, :].expand(b, t, t).clone()
    causal = torch.tril(torch.ones((ty, ty), dtype=torch.bool, device=x_valid.device))
    allow[:, tx:, tx:] &= causal[None]
    allow[:, :tx, tx:] = False
    allow |= torch.eye(t, dtype=torch.bool, device=x_valid.device)[None]
    zero = torch.zeros((), device=x_valid.device)
    return torch.where(allow[:, None], zero, torch.full((), float("-inf"), device=x_valid.device))


def filter_logits(logits, presence, *, top_k: int, top_p: float, temperature: float, repetition_penalty: float):
    """Repetition penalty -> top-p -> temperature -> top-k (AR/models/
    utils.py:147-201). Returns logits/temperature with every token outside
    the sampling support at -inf."""
    logits = logits.float()
    if repetition_penalty != 1.0:
        penalized = torch.where(logits < 0, logits * repetition_penalty, logits / repetition_penalty)
        logits = torch.where(presence, penalized, logits)
    if top_p < 1.0:
        sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove_sorted = cum > top_p
        remove_sorted[:, 0] = False
        remove = torch.zeros_like(remove_sorted).scatter(1, sorted_idx, remove_sorted)
        logits = logits.masked_fill(remove, float("-inf"))
    logits = logits / max(temperature, 1e-5)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits


def sample_token(logits, presence, generator, *, top_k, top_p, temperature, repetition_penalty):
    """Sample one token per row from the filtered distribution."""
    filtered = filter_logits(
        logits, presence, top_k=top_k, top_p=top_p, temperature=temperature, repetition_penalty=repetition_penalty
    )
    if top_k == 1:  # the support is the argmax; no random draw needed
        return filtered.argmax(-1)
    probs = torch.softmax(filtered, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class GenResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new) int64, 0-filled after EOS
    lengths: torch.Tensor  # (B,) number of valid semantic tokens
    steps: int  # loop iterations executed


@torch.no_grad()
def generate(
    model: T2SDecoder,
    phoneme_ids,  # (B, Tx) LEFT-padded
    phoneme_lens,  # (B,)
    bert_features,  # (B, Tx, bert_dim)
    prompt_ids,  # (B, Tp) RIGHT-padded
    prompt_lens,  # (B,)
    generator: torch.Generator | None = None,
    *,
    max_new_tokens: int = 1500,
    top_k: int = 15,
    top_p: float = 1.0,
    temperature: float = 1.0,
    repetition_penalty: float = 1.35,
    early_stop_num: int = -1,
    use_fused_kernel: bool = False,
    weight_quant: str = "bf16",
    kv_cache_quant: str = "bf16",
    fused_weights: dict | None = None,
) -> GenResult:
    """Batched zero-shot semantic token generation (port of t2s.py:311)."""
    cfg = model.cfg
    dev = phoneme_ids.device
    b, tx = phoneme_ids.shape
    tp = prompt_ids.shape[1]
    t_total = tx + tp + max_new_tokens
    if use_fused_kernel:
        from gpt_sovits_tpu_torch.ops.decode_step import check_step_request

        # the last step attends to a prefix of tx + tp + max_new_tokens - 2 slots
        check_step_request(dev, cfg.hidden_dim, cfg.ffn_dim, cfg.num_heads, tx + tp + max(max_new_tokens - 2, 0),
                           kv_cache_quant == "int8")
        t_total = -(-t_total // 512) * 512  # the TPU kernel's chunk; same shapes
    eos = cfg.eos_id
    rows = torch.arange(b, device=dev)

    ar = torch.arange(tx, device=dev)
    x_valid = ar[None, :] >= (tx - phoneme_lens[:, None])
    x_pos = torch.clamp(ar[None, :] - (tx - phoneme_lens[:, None]), min=0)
    arp = torch.arange(tp, device=dev)
    p_valid = arp[None, :] < prompt_lens[:, None]
    p_pos = torch.clamp(arp[None, :], 0, cfg.max_len - 1).expand(b, tp)

    x_emb = model.embed_text(phoneme_ids, bert_features, x_pos) * x_valid[..., None]
    p_emb = model.embed_audio(prompt_ids, p_pos) * p_valid[..., None]
    xy_emb = torch.cat([x_emb, p_emb], dim=1)
    _, k_pre, v_pre = model.prefill(xy_emb, build_prefix_attn_bias(x_valid, p_valid))

    pad_t = t_total - (tx + tp)
    last_pos = torch.clamp_min(prompt_lens - 1, 0)
    last_tok = prompt_ids.gather(1, last_pos[:, None])
    last_emb = model.embed_audio(last_tok, last_pos[:, None])
    valid = torch.cat([x_valid, p_valid, torch.zeros((b, pad_t), dtype=torch.bool, device=dev)], dim=1)
    scratch_idx = tx + tp

    if use_fused_kernel:
        from gpt_sovits_tpu_torch.ops.decode_step import (
            fused_decode_step, quantize_kv_cache, stack_weights_from_params,
        )

        if fused_weights is None:
            fused_weights = stack_weights_from_params(model.state_dict(), cfg.num_layers, quant=weight_quant)
        head = model.ar_predict_layer.weight.float()
        n_l, d = cfg.num_layers, cfg.hidden_dim
        kv = torch.cat([k_pre.reshape(n_l, b, tx + tp, d), v_pre.reshape(n_l, b, tx + tp, d)], dim=-1)
        kv = F.pad(kv, (0, 0, 0, pad_t)).to(torch.bfloat16)
        kv_scales = None
        if kv_cache_quant == "int8":
            kv, kv_scales = quantize_kv_cache(kv)
        elif kv_cache_quant != "bf16":
            raise ValueError(f"kv cache quant {kv_cache_quant!r}: expected 'bf16' or 'int8'")
        mask = valid.float()

        def step(tok_emb, mask_excl, write_idx):
            y = fused_decode_step(
                tok_emb[:, 0].float().contiguous(), fused_weights, kv, mask_excl, write_idx, kv_scales,
                num_heads=cfg.num_heads,
            )[0]
            return F.linear(y, head)

        # step -1: the kernel attends to the query's own fresh K/V, so the
        # last prompt token's prefill slot (identical values) is excluded
        first_mask = mask.clone()
        first_mask[rows, tx + last_pos] = 0.0
        first_logits = step(last_emb, first_mask, scratch_idx)
    else:
        k_caches = F.pad(k_pre, (0, 0, 0, 0, 0, pad_t)).contiguous()
        v_caches = F.pad(v_pre, (0, 0, 0, 0, 0, pad_t)).contiguous()
        first_logits = model.decode_step(last_emb, k_caches, v_caches, valid, scratch_idx)

    presence = torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev)
    presence[rows[:, None], torch.where(p_valid, prompt_ids, torch.full_like(prompt_ids, eos))] = True
    presence[:, eos] = False

    sample_kw = dict(top_k=top_k, top_p=top_p, temperature=temperature, repetition_penalty=repetition_penalty)
    fl = first_logits.float()
    fl[:, eos] = float("-inf")
    tok = sample_token(fl, presence, generator, **sample_kw)
    tokens = torch.zeros((b, max_new_tokens), dtype=torch.long, device=dev)
    tokens[:, 0] = tok
    presence[rows, tok] = True
    lengths = torch.ones((b,), dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    tok_emb = model.embed_audio(tok[:, None], prompt_lens[:, None])

    stop_at = max_new_tokens if early_stop_num < 0 else min(early_stop_num, max_new_tokens)
    step_i = 1
    while step_i < stop_at:
        if step_i % STOP_CHECK_EVERY == 0 and bool(done.all()):
            break
        write_idx = scratch_idx + step_i - 1
        if use_fused_kernel:
            logits = step(tok_emb, mask, write_idx)
            mask[:, write_idx] = 1.0
        else:
            valid[:, write_idx] = True
            logits = model.decode_step(tok_emb, k_caches, v_caches, valid, write_idx)
        logits = logits.float()
        if step_i < EOS_MASK_WARMUP_STEPS:
            logits[:, eos] = float("-inf")
        argmax_is_eos = logits.argmax(-1) == eos
        tok = sample_token(logits, presence, generator, **sample_kw)
        newly_done = argmax_is_eos | (tok == eos)
        tok = torch.where(done | newly_done, torch.zeros_like(tok), tok)
        tokens[:, step_i] = tok
        lengths = torch.where(done | newly_done, lengths, lengths + 1)
        done = done | newly_done
        presence[rows, tok] = True
        tok_emb = model.embed_audio(tok[:, None], (prompt_lens + step_i)[:, None])
        step_i += 1
    return GenResult(tokens=tokens, lengths=lengths, steps=step_i)


def t2s_loss(model: T2SDecoder, phoneme_ids, phoneme_lens, semantic_ids, semantic_lens, bert_features):
    """Training loss (port of t2s.py:519 `t2s_loss`): the summed
    cross-entropy of the semantic targets with EOS appended, and top-1
    accuracy over the non-EOS targets. Text is LEFT-padded (B, Tx), semantic
    ids RIGHT-padded (B, Ty) without EOS. The prediction for y_t comes from
    slot tx-1+t (the last text token predicts y_0, y_{L-1}'s slot predicts
    EOS); positions >= L are attention padding. Runs the full-sequence
    forward in float32, never the decode step.

    -> (loss, {"acc", "tokens", "logp" (B, Ty+1), "mask" (B, Ty+1)})."""
    cfg = model.cfg
    dev = phoneme_ids.device
    b, tx = phoneme_ids.shape
    ty = semantic_ids.shape[1]
    ar_x = torch.arange(tx, device=dev)
    x_valid = ar_x[None, :] >= (tx - phoneme_lens[:, None])
    x_pos = torch.clamp(ar_x[None, :] - (tx - phoneme_lens[:, None]), min=0)
    ar_y = torch.arange(ty + 1, device=dev)
    y_valid = ar_y[None, :] < semantic_lens[:, None]
    loss_valid = ar_y[None, :] < (semantic_lens[:, None] + 1)
    y_pad = F.pad(semantic_ids, (0, 1))
    y_in = torch.where(y_valid, y_pad, torch.zeros_like(y_pad))
    targets = torch.where(y_valid, y_pad, torch.full_like(y_pad, cfg.eos_id))
    y_pos = ar_y[None, :].expand(b, ty + 1)

    x_emb = model.embed_text(phoneme_ids, at_least_f32(bert_features), x_pos) * x_valid[..., None]
    y_emb = model.embed_audio(y_in, y_pos) * y_valid[..., None]
    logits = model(torch.cat([x_emb, y_emb], dim=1), build_prefix_attn_bias(x_valid, y_valid))

    pred = at_least_f32(logits[:, tx - 1 : tx + ty])  # (B, Ty+1, V)
    logp = torch.log_softmax(pred, dim=-1)
    tgt_logp = logp.gather(-1, targets[..., None])[..., 0]
    mask = loss_valid.float()
    loss = -(tgt_logp * mask).sum()
    scored = loss_valid & (targets != cfg.eos_id)
    acc = ((pred.argmax(-1) == targets) & scored).sum() / torch.clamp_min(scored.sum(), 1)
    return loss, {"acc": acc, "tokens": mask.sum(), "logp": tgt_logp, "mask": mask}
