"""S2 "SoVITS" synthesizer, v1/v2/v2Pro/v2ProPlus (port of
gpt_sovits_tpu/models/vits.py): inference, and the training forward.

Public methods keep the JAX package's feature-last layout: SSL features
(B, T, 768), reference spectrogram (B, T, bins), latents (B, T, C), ge
(B, 1, gin), waveform (B, T_wav, 1). Inside, modules run channels-first.
Parameter names are the reference's (module/models.py); weight-norm pairs
(`weight_g`/`weight_v`, or `parametrizations.weight.original0/1`) are
folded in `SynthesizerTrn.load_state_dict`.
The posterior encoder `enc_q.*` exists only in a model built for training
(`posterior=True`); an inference model drops it at load. Convolution
weights are plain tensors, in training too, as in the JAX model: weight
norm exists only in the exported reference-format files
(train/ckpt.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gpt_sovits_tpu_torch import at_least_f32
from gpt_sovits_tpu_torch.models.vits_modules import (
    MRTE,
    Conv1d,
    ConvTranspose1d,
    Encoder,
    MelStyleEncoder,
    ResBlock1,
    ResidualCouplingBlock,
    VQCodebook,
    WN,
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


def slice_segments(x, starts, length: int):
    """x (B, T, C) -> (B, length, C) from each row's start, clamped to fit
    as jax.lax.dynamic_slice clamps (ref commons.slice_segments)."""
    starts = torch.clamp(starts, 0, x.shape[1] - length)
    idx = starts[:, None] + torch.arange(length, device=x.device)[None, :]
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))


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

    def forward(self, quantized, y_mask, text, text_mask, ge, speed: float = 1.0):
        """quantized (B,768,T), y_mask (B,1,T), text (B,Tt), ge (B,C,1) ->
        (m_p, logs_p (B,inter,T'), y_mask (B,1,T'), hidden (B,hidden,T'):
        the encoder2 output the v3/v4 bridge reads)."""
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
        return stats[:, : self.inter], stats[:, self.inter :], y_mask, y


class PosteriorEncoder(nn.Module):
    """models.py:298: linear spectrogram -> WN(16 layers) -> (z, m_q, logs_q),
    z = (m_q + noise * exp(logs_q)) * mask. Training only."""

    def __init__(self, c: S2Config):
        super().__init__()
        self.inter = c.inter_channels
        self.pre = Conv1d(c.spec_channels, c.hidden_channels, 1)
        self.enc = WN(c.hidden_channels, 5, 1, 16, gin_channels=c.gin_channels)
        self.proj = Conv1d(c.hidden_channels, 2 * c.inter_channels, 1)

    def forward(self, x, x_mask, g, noise):
        """x (B,bins,T), x_mask (B,1,T), g (B,gin,1), noise (B,inter,T)."""
        h = self.pre(x) * x_mask
        h = self.enc(h, x_mask, g=g)
        stats = self.proj(h) * x_mask
        m, logs = stats[:, : self.inter], stats[:, self.inter :]
        return (m + noise * torch.exp(logs)) * x_mask, m, logs


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


# the two forms of a weight-norm pair: torch.nn.utils.weight_norm's, and the
# newer torch.nn.utils.parametrizations.weight_norm's
WEIGHT_NORM_FORMS = ((".weight_g", ".weight_v"),
                     (".parametrizations.weight.original0", ".parametrizations.weight.original1"))


def fold_weight_norm(state_dict: dict, dim: int = 0) -> dict:
    """Replace each weight-norm pair, `<p>.weight_g`/`<p>.weight_v` or
    `<p>.parametrizations.weight.original0`/`original1`, by `<p>.weight =
    g * v / ||v||`, the norm over every dim but `dim` (torch weight_norm's
    `dim`, 0 by default)."""
    out = {}
    for k, v in state_dict.items():
        for g_name, v_name in WEIGHT_NORM_FORMS:
            if ("." + k).endswith(v_name):
                break
            if ("." + k).endswith(g_name):
                p = k[: len(k) + 1 - len(g_name)]  # "<p>." ("" for a top-level module)
                wv = state_dict[p + v_name[1:]].float()
                axes = tuple(a for a in range(wv.ndim) if a != dim % wv.ndim)
                norm = torch.sqrt((wv**2).sum(dim=axes, keepdim=True))
                out[p + "weight"] = v.float() * wv / torch.clamp_min(norm, 1e-12)
                break
        else:
            out[k] = v
    return out


class SynthesizerTrn(nn.Module):
    """The S2 model (models.py:796); `posterior=True` adds the posterior
    encoder `enc_q` that the training forward needs."""

    def __init__(self, cfg: S2Config, *, posterior: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.posterior = posterior
        self.enc_p = TextEncoder(c)
        self.dec = Generator(c)
        if posterior:
            self.enc_q = PosteriorEncoder(c)
        self.flow = ResidualCouplingBlock(c.inter_channels, c.hidden_channels, 5, 1, 4, gin_channels=c.gin_channels)
        self.ref_dim = c.spec_channels if c.version == "v1" else min(704, c.spec_channels)
        self.ref_enc = MelStyleEncoder(self.ref_dim, out_dim=c.gin_channels)
        self.ssl_proj = nn.Conv1d(c.ssl_dim, c.ssl_dim, 2, stride=2)
        self.quantizer = VQCodebook(c.n_codes, c.ssl_dim)
        if c.is_pro:
            self.sv_emb = nn.Linear(c.sv_dim, c.gin_channels)
            self.ge_to512 = nn.Linear(c.gin_channels, c.mrte_hidden)
            self.prelu = nn.PReLU(num_parameters=c.gin_channels)
        if posterior:  # a training model's initial values (modules.py:430-431, models.py init_weights)
            for i in range(0, len(self.flow.flows), 2):  # mean-only couplings start as the identity
                nn.init.zeros_(self.flow.flows[i].post.weight)
                nn.init.zeros_(self.flow.flows[i].post.bias)
            for up in self.dec.ups:
                nn.init.normal_(up.weight, 0.0, 0.01)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Reference-named S2 weights: weight norm folded here; `enc_q.*`
        (the posterior encoder) dropped unless the model was built with it."""
        sd = fold_weight_norm({k: v for k, v in state_dict.items() if self.posterior or not k.startswith("enc_q.")})
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
                      noise=None, noise_scale: float = 0.5, speed: float = 1.0, sv_emb=None, ge=None):
        """JAX `decode` minus the vocoder -> (z * y_mask (B,T,inter), ge
        (B,1,gin)). Without `noise` (what the pipeline runs) the prior's
        mean goes through the flow, as JAX's `noise_rng=None`; with it,
        (B,T,inter) standard normal draws scaled by exp(logs_p) *
        noise_scale are added first. A given `ge` (B,1,gin), such as the
        mean over auxiliary references that `set_ref_audio(aux_wavs=...)`
        keeps, replaces the timbre of the reference batch."""
        if ge is None:
            ge = self.compute_ge_masked(refer_spec, refer_lengths, sv_emb)
        ge_for_enc = self.ge_to512(ge) if self.cfg.is_pro else ge
        quantized = self.decode_codes(codes).transpose(1, 2)
        y_mask = sequence_mask(codes_lengths * 2, quantized.shape[2])
        text_mask = sequence_mask(text_lengths, text.shape[1])
        m_p, logs_p, y_mask, _ = self.enc_p(quantized, y_mask, text, text_mask, ge_for_enc.transpose(1, 2),
                                            speed=speed)
        z_p = m_p if noise is None else m_p + noise.transpose(1, 2) * torch.exp(logs_p) * noise_scale
        z = self.flow.reverse(z_p, y_mask, g=ge.transpose(1, 2))
        return (z * y_mask).transpose(1, 2), ge

    def decode(self, codes, codes_lengths, text, text_lengths, refer_spec, refer_lengths, *,
               noise=None, noise_scale: float = 0.5, speed: float = 1.0, sv_emb=None, ge=None):
        """models.py:961 `decode` (JAX `SynthesizerTrn.decode`): codes and the
        reference -> waveform (B, T_wav, 1), `decode_latent` then the
        vocoder. The prior noise is a tensor (`noise`, as in decode_latent),
        not a generator, so the function can be exported."""
        z, ge = self.decode_latent(codes, codes_lengths, text, text_lengths, refer_spec, refer_lengths, noise=noise,
                                   noise_scale=noise_scale, speed=speed, sv_emb=sv_emb, ge=ge)
        return self.dec(z, g=ge)

    # -- training -------------------------------------------------------------

    def forward(self, ssl, spec, spec_lengths, text, text_lengths, *, sv_emb=None, noise=None, ids_slice=None,
                generator: torch.Generator | None = None) -> dict:
        """models.py:901 forward (JAX `SynthesizerTrn.__call__`): ssl (B,Ts,768)
        at 50 Hz, spec (B,T,bins), text (B,Tt). The posterior noise (B,T,inter)
        and the segment starts (B,) are `noise`/`ids_slice` when given, else
        drawn from `generator` on the CPU. -> the pieces the GAN step needs,
        feature-last: wav_hat (B, segment*hop, 1), commit_loss, ids_slice,
        y_mask (B,T,1), z, z_p, m_p, logs_p, m_q, logs_q (B,T,inter)."""
        c = self.cfg
        b, t = spec.shape[:2]
        y_mask = sequence_mask(spec_lengths, t)  # (B,1,T)
        ge = self.compute_ge(spec, y_mask[:, 0], sv_emb)
        ge_for_enc = self.ge_to512(ge) if c.is_pro else ge

        x = self.ssl_proj(ssl.transpose(1, 2)).transpose(1, 2)
        quantized = self.quantizer.decode(self.quantizer.encode(x))
        # straight-through; the commit loss trains the encoder, not the
        # codebook (core_vq.py VectorQuantization: mse(quantize.detach(), x))
        commit_loss = torch.mean((quantized.detach() - x) ** 2)
        quantized = x + (quantized - x).detach()
        if c.freeze_quantizer:
            quantized = quantized.detach()
        if c.semantic_frame_rate == "25hz":
            quantized = torch.repeat_interleave(quantized, 2, dim=1)
        quantized = F.pad(quantized, (0, 0, 0, max(t - quantized.shape[1], 0)))[:, :t]

        text_mask = sequence_mask(text_lengths, text.shape[1])
        m_p, logs_p, y_mask, _ = self.enc_p(quantized.transpose(1, 2), y_mask, text, text_mask,
                                            ge_for_enc.transpose(1, 2))
        if noise is None:
            noise = torch.randn((b, t, c.inter_channels), generator=generator)
        noise = torch.as_tensor(noise).to(spec.device, at_least_f32(spec).dtype).transpose(1, 2)
        z, m_q, logs_q = self.enc_q(spec.transpose(1, 2), y_mask, ge.detach().transpose(1, 2), noise)
        z_p = self.flow(z, y_mask, g=ge.transpose(1, 2))

        seg = c.segment_size
        if ids_slice is None:  # commons.rand_slice_segments
            max_starts = torch.clamp_min(spec_lengths.cpu() - seg, 0)
            ids_slice = (torch.rand(b, generator=generator) * (max_starts + 1)).long()
        starts = torch.clamp(torch.as_tensor(ids_slice).to(spec.device).long(), 0, max(t - seg, 0))
        fl = lambda a: a.transpose(1, 2)
        wav_hat = self.dec(slice_segments(fl(z), starts, seg), g=ge)
        return {"wav_hat": wav_hat, "commit_loss": commit_loss, "ids_slice": starts, "y_mask": fl(y_mask),
                "z": fl(z), "z_p": fl(z_p), "m_p": fl(m_p), "logs_p": fl(logs_p), "m_q": fl(m_q),
                "logs_q": fl(logs_q)}
