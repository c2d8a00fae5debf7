"""VITS building blocks for inference (port of
gpt_sovits_tpu/models/vits_modules.py).

Internally channels-first (B, C, T), PyTorch's convolution layout; module
and parameter names follow the reference's state dict (modules.py,
attentions.py, mrte_model.py, core_vq.py). Masks are (B, 1, T) float,
1 = valid. Convolutions are symmetric-padded as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) -> (B, 1, T) float mask."""
    return (torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]).float()[:, None, :]


def Conv1d(cin: int, cout: int, kernel: int = 1, stride: int = 1, dilation: int = 1, bias: bool = True) -> nn.Conv1d:
    """torch Conv1d with the reference's symmetric 'same' padding."""
    return nn.Conv1d(cin, cout, kernel, stride=stride, dilation=dilation, padding=(kernel - 1) * dilation // 2, bias=bias)


def ConvTranspose1d(cin: int, cout: int, kernel: int, stride: int, pad: int) -> nn.ConvTranspose1d:
    """out_len = (T-1)*s - 2p + k, as torch's ConvTranspose1d."""
    return nn.ConvTranspose1d(cin, cout, kernel, stride=stride, padding=pad)


class LayerNorm(nn.Module):
    """LayerNorm over channels of (B, C, T); reference names gamma/beta."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma, self.beta, self.eps)
        return x.transpose(1, -1)


class WN(nn.Module):
    """WaveNet-style gated stack (ref modules.py:132)."""

    def __init__(self, hidden: int, kernel_size: int, dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.hidden = hidden
        self.n_layers = n_layers
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * hidden * n_layers, 1)
        self.in_layers = nn.ModuleList(
            Conv1d(hidden, 2 * hidden, kernel_size, dilation=dilation_rate**i) for i in range(n_layers)
        )
        self.res_skip_layers = nn.ModuleList(
            Conv1d(hidden, 2 * hidden if i < n_layers - 1 else hidden, 1) for i in range(n_layers)
        )

    def forward(self, x, x_mask, g=None):
        h = self.hidden
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if g is not None else None
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            if g_all is not None:
                x_in = x_in + g_all[:, i * 2 * h : (i + 1) * 2 * h]
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask


class ResBlock1(nn.Module):
    """HiFiGAN ResBlock1 (ref modules.py:218), no mask (the decoder's use)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(Conv1d(channels, channels, kernel_size, dilation=d) for d in dilations)
        self.convs2 = nn.ModuleList(Conv1d(channels, channels, kernel_size) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x


class ResidualCouplingLayer(nn.Module):
    """Mean-only coupling layer (ref modules.py:399), reverse direction."""

    def __init__(self, channels, hidden, kernel_size, dilation_rate, n_layers, gin_channels=0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden, 1)
        self.enc = WN(hidden, kernel_size, dilation_rate, n_layers, gin_channels=gin_channels)
        self.post = Conv1d(hidden, self.half, 1)

    def reverse(self, x, x_mask, g=None):
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = self.post(h) * x_mask
        return torch.cat([x0, (x1 - m) * x_mask], dim=1)


class Flip(nn.Module):
    """modules.Flip: reverse the channel order (no parameters)."""

    def forward(self, x):
        return torch.flip(x, dims=[1])


class ResidualCouplingBlock(nn.Module):
    """Flow of n coupling layers with flips (ref models.py:253); the state
    dict indexes the couplings at even positions, as the reference."""

    def __init__(self, channels, hidden, kernel_size, dilation_rate, n_layers, n_flows=4, gin_channels=0):
        super().__init__()
        mods = []
        for _ in range(n_flows):
            mods.append(ResidualCouplingLayer(channels, hidden, kernel_size, dilation_rate, n_layers, gin_channels))
            mods.append(Flip())
        self.flows = nn.ModuleList(mods)

    def reverse(self, x, x_mask, g=None):
        for i in reversed(range(0, len(self.flows), 2)):
            x = self.flows[i + 1](x)
            x = self.flows[i].reverse(x, x_mask, g=g)
        return x


# ---------------------------------------------------------------------------
# Relative-position transformer encoder (ref attentions.py:10/:169)
# ---------------------------------------------------------------------------


def _rel_to_abs(x):
    """(B,H,T,2T-1) relative-indexed -> (B,H,T,T) absolute-indexed."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1))
    x = x.reshape(b, h, t * 2 * t)
    x = F.pad(x, (0, t - 1))
    x = x.reshape(b, h, t + 1, 2 * t - 1)
    return x[:, :, :t, t - 1 :]


def _abs_to_rel(x):
    """(B,H,T,T) -> (B,H,T,2T-1)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    x = x.reshape(b, h, t * t + t * (t - 1))
    x = F.pad(x, (t, 0))
    x = x.reshape(b, h, t, 2 * t)
    return x[:, :, :, 1:]


def _expand_rel_emb(rel_emb, t, window_size):
    """(1, 2w+1, dk) -> (1, 2t-1, dk), zero-padded or sliced."""
    w = window_size
    pad_len = max(t - (w + 1), 0)
    start = max((w + 1) - t, 0)
    padded = F.pad(rel_emb, (0, 0, pad_len, pad_len))
    return padded[:, start : start + 2 * t - 1]


class MultiHeadAttention(nn.Module):
    """attentions.MultiHeadAttention: 1x1-conv projections; with a window,
    learned relative-position embeddings (self-attention in the encoder)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int, window_size: int | None = None):
        super().__init__()
        self.n_heads = n_heads
        self.window_size = window_size
        dk = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        if window_size is not None:
            self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, dk) * dk**-0.5)
            self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, dk) * dk**-0.5)

    def forward(self, x, c, attn_mask):
        """x (B,C,Tq), c (B,C,Tk), attn_mask (B,Tq,Tk) float (1 = attend)."""
        b, ch, tq = x.shape
        tk = c.shape[2]
        h = self.n_heads
        dk = ch // h
        scale = 1.0 / np.sqrt(dk)
        q = self.conv_q(x).reshape(b, h, dk, tq).transpose(2, 3) * scale  # (B,H,Tq,dk)
        k = self.conv_k(c).reshape(b, h, dk, tk).transpose(2, 3)
        v = self.conv_v(c).reshape(b, h, dk, tk).transpose(2, 3)
        scores = q @ k.transpose(2, 3)
        if self.window_size is not None:
            rel_k = _expand_rel_emb(self.emb_rel_k, tq, self.window_size)
            scores = scores + _rel_to_abs(q @ rel_k[0].t())
        scores = scores.masked_fill(attn_mask[:, None] <= 0, -1e4)
        probs = torch.softmax(scores, dim=-1)
        out = probs @ v
        if self.window_size is not None:
            rel_v = _expand_rel_emb(self.emb_rel_v, tq, self.window_size)
            out = out + _abs_to_rel(probs) @ rel_v[0]
        return self.conv_o(out.transpose(2, 3).reshape(b, ch, tq))


class FFN(nn.Module):
    def __init__(self, in_channels, out_channels, filter_channels, kernel_size):
        super().__init__()
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x, x_mask):
        x = torch.relu(self.conv_1(x * x_mask))
        return self.conv_2(x * x_mask) * x_mask


class Encoder(nn.Module):
    """attentions.Encoder: rel-pos self-attention + conv FFN, post-LN."""

    def __init__(self, hidden, filter_channels, n_heads, n_layers, kernel_size=1, window_size=4):
        super().__init__()
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden, hidden, n_heads, window_size=window_size) for _ in range(n_layers)
        )
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(FFN(hidden, hidden, filter_channels, kernel_size) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))

    def forward(self, x, x_mask):
        attn_mask = x_mask[:, 0, None, :] * x_mask[:, 0, :, None]
        x = x * x_mask
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers, self.norm_layers_2):
            x = n1(x + attn(x, x, attn_mask))
            x = n2(x + ffn(x, x_mask))
        return x * x_mask


class MRTE(nn.Module):
    """ref mrte_model.py:9: cross-attention of the SSL stream over the text."""

    def __init__(self, content_enc_channels=192, hidden_size=512, out_channels=192, n_heads=4):
        super().__init__()
        self.cross_attention = MultiHeadAttention(hidden_size, hidden_size, n_heads)
        self.c_pre = Conv1d(content_enc_channels, hidden_size, 1)
        self.text_pre = Conv1d(content_enc_channels, hidden_size, 1)
        self.c_post = Conv1d(hidden_size, out_channels, 1)

    def forward(self, ssl_enc, ssl_mask, text, text_mask, ge):
        attn_mask = text_mask[:, 0, None, :] * ssl_mask[:, 0, :, None]  # (B,Ts,Tt)
        ssl_h = self.c_pre(ssl_enc * ssl_mask)
        text_h = self.text_pre(text * text_mask)
        x = self.cross_attention(ssl_h * ssl_mask, text_h * text_mask, attn_mask) + ssl_h
        if ge is not None:
            x = x + ge
        return self.c_post(x * ssl_mask)


# ---------------------------------------------------------------------------
# MelStyleEncoder (ref modules.py:672)
# ---------------------------------------------------------------------------


def mish(x):
    return x * torch.tanh(F.softplus(x))


class _FC(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.fc = nn.Linear(cin, cout)


class _Conv(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = Conv1d(cin, cout, k)


class Conv1dGLU(nn.Module):
    def __init__(self, channels, kernel_size):
        super().__init__()
        self.channels = channels
        self.conv1 = _Conv(channels, 2 * channels, kernel_size)

    def forward(self, x):
        h = self.conv1.conv(x)
        return x + h[:, : self.channels] * torch.sigmoid(h[:, self.channels :])


class StyleMHA(nn.Module):
    """modules.MultiHeadAttention: scores scaled by sqrt(d_model), residual."""

    def __init__(self, n_head, d_model):
        super().__init__()
        self.n_head = n_head
        self.d_model = d_model
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)

    def forward(self, x, pad_mask):
        """x (B,T,C); pad_mask (B,T) True where padding."""
        b, t, _ = x.shape
        h, dk = self.n_head, self.d_model // self.n_head
        q = self.w_qs(x).reshape(b, t, h, dk).transpose(1, 2)
        k = self.w_ks(x).reshape(b, t, h, dk).transpose(1, 2)
        v = self.w_vs(x).reshape(b, t, h, dk).transpose(1, 2)
        scores = (q @ k.transpose(2, 3)) / np.sqrt(self.d_model)
        scores = scores.masked_fill(pad_mask[:, None, None, :], float("-inf"))
        out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, t, -1)
        return self.fc(out) + x


class MelStyleEncoder(nn.Module):
    """Reference spectrogram -> style vector ge (B, out_dim, 1)."""

    def __init__(self, in_dim, hidden_dim=128, out_dim=512, kernel_size=5, n_head=2):
        super().__init__()
        self.spectral = nn.ModuleDict({"0": _FC(in_dim, hidden_dim), "3": _FC(hidden_dim, hidden_dim)})
        self.temporal = nn.ModuleDict({"0": Conv1dGLU(hidden_dim, kernel_size), "1": Conv1dGLU(hidden_dim, kernel_size)})
        self.slf_attn = StyleMHA(n_head, hidden_dim)
        self.fc = _FC(hidden_dim, out_dim)

    def forward(self, x, mask):
        """x (B,T,in_dim) spectrogram frames; mask (B,T) float, 1 = valid."""
        pad = mask == 0
        x = mish(self.spectral["0"].fc(x))
        x = mish(self.spectral["3"].fc(x))
        x = x.transpose(1, 2)
        x = self.temporal["1"](self.temporal["0"](x)).transpose(1, 2)
        x = x.masked_fill(pad[..., None], 0.0)
        x = self.fc.fc(self.slf_attn(x, pad))
        valid = mask[..., None]
        w = (x * valid).sum(dim=1) / torch.clamp_min(valid.sum(dim=1), 1.0)
        return w[:, :, None]


class _Codebook(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.embed = nn.Parameter(torch.rand(n, dim))


class _VQLayer(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self._codebook = _Codebook(n, dim)


class _VQ(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList([_VQLayer(n, dim)])


class VQCodebook(nn.Module):
    """Euclidean nearest-code quantizer (ref core_vq.py:97, n_q=1); state
    dict key quantizer.vq.layers.0._codebook.embed."""

    def __init__(self, codebook_size: int = 1024, dim: int = 768):
        super().__init__()
        self.vq = _VQ(codebook_size, dim)

    @property
    def embed(self):
        return self.vq.layers[0]._codebook.embed

    def encode(self, x):
        """x (B,T,D) -> codes (B,T)."""
        e = self.embed
        dist = (x * x).sum(-1, keepdim=True) - 2.0 * torch.einsum("btd,kd->btk", x, e) + (e * e).sum(-1)[None, None]
        return torch.argmin(dist, dim=-1)

    def decode(self, codes):
        return F.embedding(codes, self.embed)
