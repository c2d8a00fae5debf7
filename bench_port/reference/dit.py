"""DiT flow-matching estimator of the v3/v4 mel path, float path only (a
frozen copy of the plain float composition of gpt_sovits_tpu_torch/models/dit.py
for the benchmark's reference; reference f5_tts/model/backbones/dit.py:88
and f5_tts/model/modules.py).

22 AdaLN-Zero blocks of width 1024, 16 heads of 64, ff_mult 2, rotary
embeddings on head 0 only (the reference's quirk), ConvNeXtV2 text blocks,
separate time and step-size embeddings. Tensors are feature-last (B, T, C).
The reference runs it in float32; the control run one precision step
below the serving form (`lower_precision`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port.reference.common import at_least_f32
from bench_port.reference.precision import fake_quant, fp8

# reference state-dict paths (within a DiT block) of the six big matmuls
QUANT_PATHS = ("attn.to_q", "attn.to_k", "attn.to_v", "attn.to_out.0", "ff.ff.0.0", "ff.ff.2")


@dataclass(frozen=True)
class DiTConfig:
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 100
    text_dim: int = 512
    conv_layers: int = 4
    freq_embed_dim: int = 256
    max_pos: int = 4096

def _lin(layer: nn.Linear, x):
    """layer(x) with the weights cast to x's dtype (f32 math from bf16
    weights where the JAX package promotes)."""
    return F.linear(x, layer.weight.to(x.dtype), None if layer.bias is None else layer.bias.to(x.dtype))


def _ln_f32(x, eps: float = 1e-6):
    """Affine-free LayerNorm with f32 statistics and an f32 result."""
    xf = at_least_f32(x)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def _f32(t):
    """An f32, contiguous copy (the kernels' form of the AdaLN vectors)."""
    return t.float().contiguous()


def _where_mask(mask, x):
    return x if mask is None else torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def sinus_position_embedding(t, dim: int, scale: float = 1000.0):
    """(B,) f32 -> (B, dim): log-spaced sin || cos (modules.py:149)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device) * -emb)
    arg = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0) -> np.ndarray:
    """(end, dim) [cos || sin] table (modules.py:196)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    f = np.outer(np.arange(end), freqs)
    return np.concatenate([np.cos(f), np.sin(f)], axis=-1).astype(np.float32)


def rope_rotate(x, t_len: int, dim_head: int):
    """Rotary embedding as the reference applies it: on the (B, T, H*dh)
    projection before the head split, with a dim_head-wide table, so only
    the first dim_head channels rotate (interleaved pairs; dit.py:135)."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim_head, 2).astype(np.float64) / dim_head))
    freqs = np.repeat(np.einsum("t,f->tf", np.arange(t_len), inv_freq), 2, axis=-1)
    cos = torch.from_numpy(np.cos(freqs)).to(device=x.device, dtype=x.dtype)
    sin = torch.from_numpy(np.sin(freqs)).to(device=x.device, dtype=x.dtype)
    b, tl, _ = x.shape
    x_rot = x[..., :dim_head]
    pairs = x_rot.reshape(b, tl, dim_head // 2, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(b, tl, dim_head)
    return torch.cat([x_rot * cos[None] + rot * sin[None], x[..., dim_head:]], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, freq_embed_dim: int = 256):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.time_mlp = nn.Sequential(nn.Linear(freq_embed_dim, dim), nn.SiLU(), nn.Linear(dim, dim))

    def forward(self, t):
        """(B,) f32 -> (B, dim) f32."""
        h = sinus_position_embedding(at_least_f32(t), self.freq_embed_dim)
        return _lin(self.time_mlp[2], F.silu(_lin(self.time_mlp[0], h)))


class GRN(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x, mask=None):
        sq = _where_mask(mask, x * x)  # L2 over real frames only
        gx = torch.sqrt(sq.sum(dim=1, keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma.to(x.dtype) * (x * nx) + self.beta.to(x.dtype) + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x, mask=None):
        """(B, T, dim); pad frames are zeroed again after the block."""
        residual = x
        c = self.dwconv
        x = F.conv1d(x.transpose(1, 2), c.weight.to(x.dtype), c.bias.to(x.dtype), padding=3, groups=c.groups)
        x = x.transpose(1, 2)
        n = self.norm
        x = F.layer_norm(x, (x.shape[-1],), n.weight.to(x.dtype), n.bias.to(x.dtype), n.eps)
        x = F.gelu(_lin(self.pwconv1, x))
        x = self.grn(x, mask)
        x = residual + _lin(self.pwconv2, x)
        return _where_mask(mask, x)


class TextEmbedding(nn.Module):
    def __init__(self, text_dim: int, conv_layers: int = 4, max_pos: int = 4096):
        super().__init__()
        self.text_dim = text_dim
        self.max_pos = max_pos
        self.text_blocks = nn.ModuleList(ConvNeXtV2Block(text_dim, text_dim * 2) for _ in range(conv_layers))

    def forward(self, text, drop_text: bool = False, mask=None):
        """text (B, T, text_dim) conditioning features -> f32 (B, T, text_dim)
        (the f32 position table promotes the sum, as in the JAX package)."""
        if drop_text:
            text = torch.zeros_like(text)
        t = text.shape[1]
        text = at_least_f32(text)
        table = torch.from_numpy(precompute_freqs_cis(self.text_dim, self.max_pos)).to(text.device, text.dtype)
        pos = table[torch.clamp(torch.arange(t, device=text.device), max=self.max_pos - 1)]
        text = _where_mask(mask, text + pos[None])
        for blk in self.text_blocks:
            text = blk(text, mask)
        return text


def _mish(x):
    return x * torch.tanh(F.softplus(x))


class ConvPositionEmbedding(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16):
        super().__init__()
        self.conv1d = nn.ModuleList([
            nn.Conv1d(dim, dim, kernel_size, padding=kernel_size // 2, groups=groups), nn.Mish(),
            nn.Conv1d(dim, dim, kernel_size, padding=kernel_size // 2, groups=groups), nn.Mish(),
        ])

    def forward(self, x, mask=None):
        """(B, T, dim); conv2 sees 'same'-padding zeros at pad frames."""
        x = _mish(self.conv1d[0](x.transpose(1, 2)).transpose(1, 2))
        x = _where_mask(mask, x)
        return _mish(self.conv1d[2](x.transpose(1, 2)).transpose(1, 2))


class InputEmbedding(nn.Module):
    def __init__(self, mel_dim: int, text_dim: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(mel_dim * 2 + text_dim, out_dim)
        self.conv_pos_embed = ConvPositionEmbedding(out_dim)

    def forward(self, x, cond, text_embed, drop_audio_cond: bool = False, mask=None):
        if drop_audio_cond:
            cond = torch.zeros_like(cond)
        h = _where_mask(mask, self.proj(torch.cat([x, cond, text_embed], dim=-1)))
        return _where_mask(mask, self.conv_pos_embed(h, mask) + h)


class _Linear(nn.Module):
    """A module holding one Linear as `.linear` (the reference's AdaLN
    modules, whose only parameters are `linear.*`)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.linear = nn.Linear(fin, fout)


class _Attention(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.ff = nn.ModuleList([nn.ModuleList([nn.Linear(dim, hidden)]), nn.Identity(), nn.Linear(hidden, dim)])


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.heads * cfg.dim_head
        self.attn_norm = _Linear(cfg.dim, 6 * cfg.dim)  # ada_linear
        self.attn = _Attention(cfg.dim, inner)
        self.ff = _FeedForward(cfg.dim, cfg.dim * cfg.ff_mult)

    def forward(self, x, t_emb, mask):
        """x (B, T, dim), t_emb (B, dim), mask (B, T) bool."""
        c = self.cfg
        mod = self.attn_norm.linear(F.silu(t_emb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        a, f = self.attn, self.ff.ff
        ff1, ff2 = f[0][0], f[2]
        b, tl, _ = x.shape
        norm = _ln_f32(x).to(x.dtype) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        q = rope_rotate(a.to_q(norm), tl, c.dim_head).reshape(b, tl, c.heads, c.dim_head)
        k = rope_rotate(a.to_k(norm), tl, c.dim_head).reshape(b, tl, c.heads, c.dim_head)
        v = a.to_v(norm).reshape(b, tl, c.heads, c.dim_head)
        scores = torch.einsum("bqhd,bkhd->bhqk", at_least_f32(q), at_least_f32(k)) / np.sqrt(c.dim_head)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = a.to_out[0](torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, tl, -1))
        x = x + gate_msa[:, None] * _where_mask(mask, attn)
        norm2 = _ln_f32(x).to(x.dtype) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        ff = ff2(F.gelu(ff1(norm2), approximate="tanh"))
        return x + gate_mlp[:, None] * ff


class DiT(nn.Module):
    def __init__(self, cfg: DiTConfig = DiTConfig()):
        super().__init__()
        self.cfg = cfg
        self.time_embed = TimestepEmbedding(cfg.dim, cfg.freq_embed_dim)
        self.d_embed = TimestepEmbedding(cfg.dim, cfg.freq_embed_dim)
        self.text_embed = TextEmbedding(cfg.text_dim, cfg.conv_layers, cfg.max_pos)
        self.input_embed = InputEmbedding(cfg.mel_dim, cfg.text_dim, cfg.dim)
        self.transformer_blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.norm_out = _Linear(cfg.dim, 2 * cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.mel_dim)

    def forward(self, x, cond, t, dt_base, text, mask=None, *, drop_audio_cond: bool = False,
                drop_text: bool = False, text_embed_cache=None):
        """x, cond (B, T, mel) in the working dtype, t and dt_base (B,),
        text (B, T, text_dim), mask (B, T) bool -> (velocity (B, T, mel),
        text embedding (B, T, text_dim), to pass back as text_embed_cache)."""
        t_emb = (self.time_embed(t) + self.d_embed(dt_base)).to(x.dtype)
        if text_embed_cache is not None:
            text_embed = text_embed_cache
        else:
            text_embed = self.text_embed(text, drop_text=drop_text, mask=mask)
        text_embed = text_embed.to(x.dtype)
        h = self.input_embed(x, cond, text_embed, drop_audio_cond=drop_audio_cond, mask=mask).to(x.dtype).contiguous()
        for blk in self.transformer_blocks:
            h = blk(h, t_emb, mask)
        scale, shift = self.norm_out.linear(F.silu(t_emb)).chunk(2, dim=-1)
        h = _ln_f32(h).to(x.dtype) * (1 + scale[:, None]) + shift[:, None]
        return self.proj_out(h), text_embed


def _quant_inputs(bits: int):
    def hook(module, args):
        return (fake_quant(args[0], bits),) + tuple(args[1:])

    return hook


def _fp8_output(module, args, out):
    return fp8(out)


def lower_precision(dit: DiT, bits: int) -> None:
    """The DiT one precision step below its serving form (the control run):
    the six big matmuls of every block, W8A8 when served, at `bits` bits,
    weights and inputs (each weight rounded in place with one scale an
    output channel, each input at every call with one scale a frame); and
    the residual stream between blocks, bf16 when served, in fp8."""
    with torch.no_grad():
        for name, m in dit.named_modules():
            if any(name.endswith(q) for q in QUANT_PATHS) and isinstance(m, nn.Linear):
                m.weight.copy_(fake_quant(m.weight, bits, dim=1))
                m.register_forward_pre_hook(_quant_inputs(bits))
            elif isinstance(m, DiTBlock):
                m.register_forward_hook(_fp8_output)
