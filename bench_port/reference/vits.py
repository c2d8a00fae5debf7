"""S2 "SoVITS" synthesizer, inference (a frozen copy of the plain float
composition of gpt_sovits_tpu_torch/models/vits.py for the benchmark's
reference): the text encoder with MRTE, the flow, the HiFiGAN generator,
timbre (`compute_ge`) and semantic codes (`extract_latent`). Speed 1 only:
the benchmark's traffic does not change the speed.

Public methods keep the feature-last layout: SSL features (B, T, 768),
reference spectrogram (B, T, bins), latents (B, T, C), ge (B, 1, gin),
waveform (B, T_wav, 1). Parameter names are the reference project's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port.reference.common import S2Config
from bench_port.reference.vits_modules import (
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


class TextEncoder(nn.Module):
    """models.py:154: SSL branch + text branch fused by MRTE -> the prior
    (m_p, logs_p)."""

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

    def forward(self, quantized, y_mask, text, text_mask, ge):
        """quantized (B,768,T), y_mask (B,1,T), text (B,Tt), ge (B,C,1) ->
        (m_p, logs_p (B,inter,T'), y_mask (B,1,T'), hidden (B,hidden,T'):
        the encoder2 output the v3/v4 bridge reads)."""
        y = self.ssl_proj(quantized * y_mask) * y_mask
        y = self.encoder_ssl(y, y_mask)
        t = self.text_embedding(text).transpose(1, 2)
        t = self.encoder_text(t * text_mask, text_mask)
        y = self.mrte(y, y_mask, t, text_mask, ge)
        y = self.encoder2(y, y_mask)
        stats = self.proj(y) * y_mask
        return stats[:, : self.inter], stats[:, self.inter :], y_mask, y


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


class SynthesizerTrn(nn.Module):
    """The S2 model (models.py:796), for inference."""

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
                      sv_emb=None, ge=None):
        """-> (z * y_mask (B,T,inter), ge (B,1,gin)): the prior's mean
        through the flow (no noise, as the pipeline decodes)."""
        if ge is None:
            ge = self.compute_ge_masked(refer_spec, refer_lengths, sv_emb)
        ge_for_enc = self.ge_to512(ge) if self.cfg.is_pro else ge
        quantized = self.decode_codes(codes).transpose(1, 2)
        y_mask = sequence_mask(codes_lengths * 2, quantized.shape[2])
        text_mask = sequence_mask(text_lengths, text.shape[1])
        m_p, _, y_mask, _ = self.enc_p(quantized, y_mask, text, text_mask, ge_for_enc.transpose(1, 2))
        z = self.flow.reverse(m_p, y_mask, g=ge.transpose(1, 2))
        return (z * y_mask).transpose(1, 2), ge
