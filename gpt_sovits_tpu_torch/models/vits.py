"""S2 "SoVITS" synthesizer for inference, v1/v2/v2Pro/v2ProPlus (port of
gpt_sovits_tpu/models/vits.py).

Public methods keep the JAX package's feature-last layout: SSL features
(B, T, 768), reference spectrogram (B, T, bins), latents (B, T, C), ge
(B, 1, gin), waveform (B, T_wav, 1). Inside, modules run channels-first.
Parameter names are the reference's (module/models.py); weight-norm pairs
(`weight_g`/`weight_v`) are folded in `SynthesizerTrn.load_state_dict`, and
the posterior encoder `enc_q.*`, which only training uses, is dropped there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gpt_sovits_tpu_torch.models.vits_modules import (
    MRTE,
    Conv1d,
    ConvTranspose1d,
    Encoder,
    MelStyleEncoder,
    ResBlock1,
    ResidualCouplingBlock,
    VQCodebook,
    sequence_mask,
)
from gpt_sovits_tpu_torch.utils.config import S2Config


def _linear_resize_matrix(t_in: int, t_out: int) -> np.ndarray:
    """(t_in, t_out) weights of jax.image.resize(..., "linear") along one
    axis, antialiased: when it shrinks, the triangle kernel widens by the
    scale factor (torch's interpolate does not), so the port uses the same
    matrix. Computed in float32 as jax does."""
    f32 = np.float32
    scale = t_out / t_in
    inv_scale = 1.0 / scale
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(t_out, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(t_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= t_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def _nearest_resize_index(t_in: int, t_out: int) -> np.ndarray:
    """Source index of jax.image.resize(..., "nearest")."""
    off = (np.arange(t_out, dtype=np.float32) + np.float32(0.5)) * np.float32(t_in) / np.float32(t_out)
    return np.floor(off.astype(np.float32)).astype(np.int64)


class TextEncoder(nn.Module):
    """models.py:154: SSL branch + text branch fused by MRTE -> the prior
    mean m_p (the log-scale half of `proj` serves only noise, which
    inference does not draw)."""

    def __init__(self, c: S2Config):
        super().__init__()
        self.inter = c.inter_channels
        h, f, nh, k = c.hidden_channels, c.filter_channels, c.n_heads, c.kernel_size
        self.ssl_proj = Conv1d(c.ssl_dim, h, 1)
        self.encoder_ssl = Encoder(h, f, nh, c.n_layers // 2, k)
        self.text_embedding = nn.Embedding(c.phoneme_vocab_size, h)
        self.encoder_text = Encoder(h, f, nh, c.n_layers, k)
        self.mrte = MRTE(h, c.mrte_hidden, h)
        self.encoder2 = Encoder(h, f, nh, c.n_layers // 2, k)
        self.proj = Conv1d(h, 2 * c.inter_channels, 1)

    def forward(self, quantized, y_mask, text, text_mask, ge, speed: float = 1.0):
        """quantized (B,768,T), y_mask (B,1,T), text (B,Tt), ge (B,C,1) ->
        (m_p (B,inter,T'), y_mask (B,1,T'), hidden (B,hidden,T'): the
        encoder2 output the v3/v4 bridge reads)."""
        y = self.ssl_proj(quantized * y_mask) * y_mask
        y = self.encoder_ssl(y, y_mask)
        t = self.text_embedding(text).transpose(1, 2)
        t = self.encoder_text(t * text_mask, text_mask)
        y = self.mrte(y, y_mask, t, text_mask, ge)
        y = self.encoder2(y, y_mask)
        if speed != 1.0:
            t_in = y.shape[2]
            new_t = int(t_in / speed) + 1
            w = torch.from_numpy(_linear_resize_matrix(t_in, new_t)).to(y)
            y = y @ w
            idx = torch.from_numpy(_nearest_resize_index(t_in, new_t)).to(y.device)
            y_mask = (y_mask[:, :, idx] > 0).to(y.dtype)
        stats = self.proj(y) * y_mask
        return stats[:, : self.inter], y_mask, y


class Generator(nn.Module):
    """MRF HiFiGAN (models.py:407): upsample x prod(rates); tanh output.

    The v4 vocoder is this generator on mels (`in_channels` 100) with the
    rates and kernels of `vocoder_v4_config()`, a bias on conv_post and no
    `cond` (the JAX module creates `cond` only when called with g; here
    `conditioned` says so)."""

    def __init__(self, c: S2Config, *, in_channels: int | None = None, use_post_bias: bool = False,
                 conditioned: bool = True):
        super().__init__()
        uic = c.upsample_initial_channel
        self.n_k = len(c.resblock_kernel_sizes)
        self.conv_pre = Conv1d(in_channels or c.inter_channels, uic, 7)
        if conditioned and c.gin_channels:
            self.cond = Conv1d(c.gin_channels, uic, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch = uic // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(uic // (2**i), ch, k, u, (k - u) // 2))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = Conv1d(ch, 1, 7, bias=use_post_bias)

    def forward(self, x, g=None):
        """x (B,T,inter), g (B,1,gin) -> (B, T*prod(rates), 1)."""
        x = self.conv_pre(x.transpose(1, 2))
        if g is not None:
            x = x + self.cond(g.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, 0.1))
            xs = None
            for j in range(self.n_k):
                r = self.resblocks[i * self.n_k + j](x)
                xs = r if xs is None else xs + r
            x = xs / self.n_k
        # the reference's final activation uses torch's default slope 0.01
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x).transpose(1, 2)


def fold_weight_norm(state_dict: dict) -> dict:
    """Replace each `<p>.weight_g`/`<p>.weight_v` pair by `<p>.weight =
    g * v / ||v||` (norm over every dim but 0, torch weight_norm's dim=0)."""
    out = {}
    for k, v in state_dict.items():
        if k.endswith(".weight_v"):
            continue
        if k.endswith(".weight_g"):
            p = k[: -len(".weight_g")]
            wv = state_dict[f"{p}.weight_v"].float()
            norm = torch.sqrt((wv**2).sum(dim=tuple(range(1, wv.ndim)), keepdim=True))
            out[f"{p}.weight"] = v.float() * wv / torch.clamp_min(norm, 1e-12)
            continue
        out[k] = v
    return out


class SynthesizerTrn(nn.Module):
    """The S2 model's inference half (models.py:796)."""

    def __init__(self, cfg: S2Config):
        super().__init__()
        c = self.cfg = cfg
        self.enc_p = TextEncoder(c)
        self.dec = Generator(c)
        self.flow = ResidualCouplingBlock(c.inter_channels, c.hidden_channels, 5, 1, 4, gin_channels=c.gin_channels)
        self.ref_dim = c.spec_channels if c.version == "v1" else min(704, c.spec_channels)
        self.ref_enc = MelStyleEncoder(self.ref_dim, out_dim=c.gin_channels)
        self.ssl_proj = nn.Conv1d(c.ssl_dim, c.ssl_dim, 2, stride=2)
        self.quantizer = VQCodebook(c.n_codes, c.ssl_dim)
        if c.is_pro:
            self.sv_emb = nn.Linear(c.sv_dim, c.gin_channels)
            self.ge_to512 = nn.Linear(c.gin_channels, c.mrte_hidden)
            self.prelu = nn.PReLU(num_parameters=c.gin_channels)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Reference-named S2 weights: weight norm folded here; `enc_q.*`
        (the posterior encoder, used only in training) dropped."""
        sd = fold_weight_norm({k: v for k, v in state_dict.items() if not k.startswith("enc_q.")})
        return super().load_state_dict(sd, strict=strict, assign=assign)

    # -- timbre ---------------------------------------------------------------

    def compute_ge(self, refer_spec, refer_mask, sv_emb=None):
        """refer_spec (B,T,bins), refer_mask (B,T) -> ge (B,1,gin)."""
        ref = refer_spec[..., : self.ref_dim]
        ge = self.ref_enc(ref * refer_mask[..., None], refer_mask).transpose(1, 2)
        if self.cfg.is_pro and sv_emb is not None:
            ge = ge + self.sv_emb(sv_emb)[:, None, :]
            ge = torch.where(ge >= 0, ge, ge * self.prelu.weight)
        return ge

    def compute_ge_masked(self, refer_spec, refer_lengths, sv_emb=None):
        refer_mask = sequence_mask(refer_lengths, refer_spec.shape[1])[:, 0]
        return self.compute_ge(refer_spec, refer_mask, sv_emb)

    # -- semantic codes -------------------------------------------------------

    def extract_latent(self, ssl):
        """(B,T,768) 50 Hz SSL -> (B,T//2) codes (models.py:1007)."""
        x = self.ssl_proj(ssl.transpose(1, 2)).transpose(1, 2)
        return self.quantizer.encode(x)

    def decode_codes(self, codes):
        """codes (B,Tc) -> quantized features (B,2*Tc,768)."""
        q = self.quantizer.decode(codes)
        if self.cfg.semantic_frame_rate == "25hz":
            q = torch.repeat_interleave(q, 2, dim=1)
        return q

    # -- inference ------------------------------------------------------------

    def decode_latent(self, codes, codes_lengths, text, text_lengths, refer_spec, refer_lengths, *,
                      speed: float = 1.0, sv_emb=None, ge=None):
        """JAX `decode` minus the vocoder, without prior noise (what the
        pipeline runs) -> (z * y_mask (B,T,inter), ge (B,1,gin)). A given
        `ge` (B,1,gin), such as the mean over auxiliary references that
        `set_ref_audio(aux_wavs=...)` keeps, replaces the timbre of the
        reference batch."""
        if ge is None:
            ge = self.compute_ge_masked(refer_spec, refer_lengths, sv_emb)
        ge_for_enc = self.ge_to512(ge) if self.cfg.is_pro else ge
        quantized = self.decode_codes(codes).transpose(1, 2)
        y_mask = sequence_mask(codes_lengths * 2, quantized.shape[2])
        text_mask = sequence_mask(text_lengths, text.shape[1])
        m_p, y_mask, _ = self.enc_p(quantized, y_mask, text, text_mask, ge_for_enc.transpose(1, 2), speed=speed)
        z = self.flow.reverse(m_p, y_mask, g=ge.transpose(1, 2))
        return (z * y_mask).transpose(1, 2), ge
