"""The v4 synthesizer's inference path (a frozen copy of the plain float
composition of gpt_sovits_tpu_torch/models/v3.py for the benchmark's
reference): `decode_encp` (the S2 text encoder, the bridge, the x2
interpolation and the WN encoder give the DiT's conditioning) and the Euler
sampler `cfm_inference`. Speed 1 only; no classifier-free guidance (the
pipeline runs none).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port.reference.common import S2Config
from bench_port.reference.dit import DiT, DiTConfig
from bench_port.reference.vits import TextEncoder
from bench_port.reference.vits_modules import WN, Conv1d, MelStyleEncoder, VQCodebook, sequence_mask


def interpolate_nearest(x: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, T, C) nearest-neighbour time interpolation by a float factor, as
    F.interpolate(..., scale_factor=s, mode='nearest')."""
    out_t = int(x.shape[1] * scale)
    idx = np.floor(np.arange(out_t) / scale).astype(np.int64)
    return x[:, torch.from_numpy(idx).to(x.device)]


class WNEncoder(nn.Module):
    """models.py:340 `Encoder`: 1x1 pre -> WN -> 1x1 proj (no flow split)."""

    def __init__(self, hidden: int, out: int, kernel_size: int = 5, n_layers: int = 8, gin_channels: int = 0):
        super().__init__()
        self.pre = Conv1d(hidden, hidden, 1)
        self.enc = WN(hidden, kernel_size, 1, n_layers, gin_channels=gin_channels)
        self.proj = Conv1d(hidden, out, 1)

    def forward(self, x, x_mask, g=None):
        """x (B, C, T), x_mask (B, 1, T), g (B, gin, 1)."""
        h = self.pre(x) * x_mask
        return self.proj(self.enc(h, x_mask, g=g)) * x_mask


class _Bridge(nn.Sequential):
    """The reference's nn.Sequential(Conv1d(hidden, 512, 1), LeakyReLU)."""

    def __init__(self, cin: int):
        super().__init__(Conv1d(cin, 512, 1), nn.LeakyReLU(0.01))


class CFM(nn.Module):
    """Conditional flow matching over the DiT estimator (models.py:1013)."""

    def __init__(self, dit_cfg: DiTConfig):
        super().__init__()
        self.estimator = DiT(dit_cfg)


class SynthesizerTrnV3(nn.Module):
    """The v3/v4 synthesizer (models.py:1128), for inference."""

    def __init__(self, cfg: S2Config):
        super().__init__()
        if cfg.version not in ("v3", "v4"):
            raise ValueError(f"SynthesizerTrnV3 serves v3/v4, got {cfg.version!r}")
        c = self.cfg = cfg
        self.enc_p = TextEncoder(c)
        self.ref_dim = min(704, c.spec_channels)
        self.ref_enc = MelStyleEncoder(self.ref_dim, out_dim=c.gin_channels)
        self.ssl_proj = nn.Conv1d(c.ssl_dim, c.ssl_dim, 2, stride=2)
        self.quantizer = VQCodebook(c.n_codes, c.ssl_dim)
        self.bridge = _Bridge(c.hidden_channels)
        self.wns1 = WNEncoder(512, 512, 5, 8, gin_channels=c.gin_channels)
        self.cfm = CFM(self.dit_config)

    @property
    def interp_factor(self) -> float:
        return 1.875 if self.cfg.version == "v3" else 2.0

    @property
    def dit_config(self) -> DiTConfig:
        c = self.cfg
        return DiTConfig(dim=c.cfm_dit_dim, depth=c.cfm_dit_depth, heads=c.cfm_dit_heads, ff_mult=2,
                         mel_dim=c.cfm_mel_channels, text_dim=512, conv_layers=4)

    def compute_ge(self, refer_spec, refer_mask):
        """refer_spec (B, T, bins), refer_mask (B, T) -> ge (B, 1, gin)."""
        ref = refer_spec[..., : self.ref_dim]
        return self.ref_enc(ref * refer_mask[..., None], refer_mask).transpose(1, 2)

    def extract_latent(self, ssl):
        """(B, T, 768) 50 Hz SSL -> (B, T//2) codes."""
        x = self.ssl_proj(ssl.transpose(1, 2)).transpose(1, 2)
        return self.quantizer.encode(x)

    def decode_encp(self, codes, codes_lengths, text, text_lengths, refer_spec, refer_lengths, *,
                    ge=None):
        """codes (B, Tc) + the reference -> (DiT conditioning fea (B, T, 512),
        ge (B, 1, gin), mel_len (B,)) (models.py:1245)."""
        c = self.cfg
        if ge is None:
            ge = self.compute_ge(refer_spec, sequence_mask(refer_lengths, refer_spec.shape[1])[:, 0])
        quantized = torch.repeat_interleave(self.quantizer.decode(codes), 2, dim=1)  # 25 Hz -> 50 Hz
        y_mask = sequence_mask(codes_lengths * 2, quantized.shape[1])
        text_mask = sequence_mask(text_lengths, text.shape[1])
        _, _, _, x = self.enc_p(quantized.transpose(1, 2), y_mask, text, text_mask, ge.transpose(1, 2))
        fea = interpolate_nearest(self.bridge(x).transpose(1, 2), self.interp_factor)
        f = np.float32(3.875 if c.version == "v3" else 4)
        mel_len = (codes_lengths.float() * float(f)).to(torch.int64)
        # the reference slices fea to a nominal length that can exceed the
        # interpolated content (models.py:1254-1266); clamp to the content
        content_len = torch.floor(codes_lengths.float() * 2 * self.interp_factor).to(torch.int64)
        mel_len = torch.clamp(torch.minimum(mel_len, content_len), max=fea.shape[1])
        mel_mask = sequence_mask(mel_len, fea.shape[1])
        fea = self.wns1(fea.transpose(1, 2), mel_mask, g=ge.transpose(1, 2)).transpose(1, 2)
        return fea, ge, mel_len


@torch.no_grad()
def cfm_inference(dit: DiT, mu, x_lens, prompt, *, noise, n_steps: int = 32):
    """Euler sampler (models.py:1027-1084) over dit, the text conditioner
    computed at step 0 and reused.

    mu (B, T, 512) conditioning, x_lens (B,), prompt (B, Tp, mel) normalized
    reference mel, noise (B, T, mel) the initial noise. Returns (B, T, mel)
    in mu's dtype."""
    b, t = mu.shape[0], mu.shape[1]
    mel_dim = dit.cfg.mel_dim
    dev, dtype = mu.device, mu.dtype
    if tuple(noise.shape) != (b, t, mel_dim):
        raise ValueError(f"noise: shape {tuple(noise.shape)}, expected {(b, t, mel_dim)}")
    x = noise.to(dev).float().to(dtype)
    prompt_len = prompt.shape[1]
    prompt_x = F.pad(prompt.to(dtype), (0, 0, 0, t - prompt_len))
    region = (torch.arange(t, device=dev) < prompt_len)[None, :, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    x = torch.where(region, zero, x)
    mask = torch.arange(t, device=dev)[None, :] < x_lens.to(dev)[:, None]
    d = 1.0 / n_steps
    d_vec = torch.full((b,), d, dtype=dtype, device=dev)

    v0, text_embed = dit(x, prompt_x, torch.zeros((b,), dtype=dtype, device=dev), d_vec, mu, mask)
    x = torch.where(region, zero, x + d * v0)
    for i in range(1, n_steps):
        t_vec = torch.full((b,), i * d, dtype=dtype, device=dev)
        v, _ = dit(x, prompt_x, t_vec, d_vec, mu, mask, text_embed_cache=text_embed)
        x = torch.where(region, zero, x + d * v)
    return x
