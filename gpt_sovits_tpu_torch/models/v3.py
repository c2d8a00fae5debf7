"""v3/v4 synthesizer for inference: semantic codes -> CFM flow-matching mel
(port of gpt_sovits_tpu/models/v3.py; reference `SynthesizerTrnV3` and `CFM`,
module/models.py:1013-1275).

Shares TextEncoder, MelStyleEncoder and the VQ codebook with the v2 stack,
and adds the bridge (1x1 conv + leaky_relu 0.01 to 512 channels), nearest
interpolation x1.875 (v3) or x2 (v4), the WN encoder `wns1` and the CFM's
DiT estimator. `cfm_inference` is the Euler sampler with the text
conditioner computed once (step 0). Public tensors are feature-last as in
the JAX package; parameter names are the reference's, with weight norm
folded at load. The training forward and `SynthesizerTrnV3b` are not ported
yet (ROADMAP.md, training slice).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gpt_sovits_tpu_torch.models.dit import DiT, DiTConfig
from gpt_sovits_tpu_torch.models.vits import TextEncoder, fold_weight_norm
from gpt_sovits_tpu_torch.models.vits_modules import WN, Conv1d, MelStyleEncoder, VQCodebook, sequence_mask
from gpt_sovits_tpu_torch.utils.config import S2Config


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


class _CFM(nn.Module):
    def __init__(self, dit_cfg: DiTConfig):
        super().__init__()
        self.estimator = DiT(dit_cfg)


class SynthesizerTrnV3(nn.Module):
    """Inference half of the v3/v4 synthesizer (models.py:1128)."""

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
        self.cfm = _CFM(self.dit_config)

    @property
    def interp_factor(self) -> float:
        return 1.875 if self.cfg.version == "v3" else 2.0

    @property
    def dit_config(self) -> DiTConfig:
        c = self.cfg
        return DiTConfig(dim=c.cfm_dit_dim, depth=c.cfm_dit_depth, heads=c.cfm_dit_heads, ff_mult=2,
                         mel_dim=c.cfm_mel_channels, text_dim=512, conv_layers=4)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Reference-named v3/v4 weights, weight norm folded here."""
        return super().load_state_dict(fold_weight_norm(dict(state_dict)), strict=strict, assign=assign)

    def compute_ge(self, refer_spec, refer_mask):
        """refer_spec (B, T, bins), refer_mask (B, T) -> ge (B, 1, gin)."""
        ref = refer_spec[..., : self.ref_dim]
        return self.ref_enc(ref * refer_mask[..., None], refer_mask).transpose(1, 2)

    def extract_latent(self, ssl):
        """(B, T, 768) 50 Hz SSL -> (B, T//2) codes."""
        x = self.ssl_proj(ssl.transpose(1, 2)).transpose(1, 2)
        return self.quantizer.encode(x)

    def decode_encp(self, codes, codes_lengths, text, text_lengths, refer_spec, refer_lengths, *,
                    speed: float = 1.0, ge=None):
        """codes (B, Tc) + the reference -> (DiT conditioning fea (B, T, 512),
        ge (B, 1, gin), mel_len (B,)) (models.py:1245)."""
        c = self.cfg
        if ge is None:
            ge = self.compute_ge(refer_spec, sequence_mask(refer_lengths, refer_spec.shape[1])[:, 0])
        quantized = torch.repeat_interleave(self.quantizer.decode(codes), 2, dim=1)  # 25 Hz -> 50 Hz
        y_mask = sequence_mask(codes_lengths * 2, quantized.shape[1])
        text_mask = sequence_mask(text_lengths, text.shape[1])
        _, _, _, x = self.enc_p(quantized.transpose(1, 2), y_mask, text, text_mask, ge.transpose(1, 2), speed=speed)
        fea = interpolate_nearest(self.bridge(x).transpose(1, 2), self.interp_factor)
        f = np.float32(3.875 if c.version == "v3" else 4)
        mel_len = codes_lengths.float() * float(f)
        if speed != 1.0:
            mel_len = (mel_len / speed).to(torch.int64) + 1
        else:
            mel_len = mel_len.to(torch.int64)
        # the reference slices fea to a nominal length that can exceed the
        # interpolated content (models.py:1254-1266); clamp to the content
        content_len = torch.floor(codes_lengths.float() * 2 * self.interp_factor).to(torch.int64)
        mel_len = torch.clamp(torch.minimum(mel_len, content_len), max=fea.shape[1])
        mel_mask = sequence_mask(mel_len, fea.shape[1])
        fea = self.wns1(fea.transpose(1, 2), mel_mask, g=ge.transpose(1, 2)).transpose(1, 2)
        return fea, ge, mel_len


@torch.no_grad()
def cfm_inference(dit: DiT, mu, x_lens, prompt, *, noise=None, generator=None, n_steps: int = 32,
                  temperature: float = 1.0, cfg_rate: float = 0.0, pad_t_to: int = 0):
    """Euler sampler (models.py:1027-1084) over dit, the text conditioner
    computed at step 0 and reused.

    mu (B, T, 512) conditioning in the working dtype, x_lens (B,), prompt
    (B, Tp, mel) normalized reference mel. The initial noise is `noise`
    (B, T, mel) f32 when given, else drawn in f32 from `generator`; either
    way scaled by temperature and cast to mu's dtype. pad_t_to > 0 pads T to
    a multiple of it (pad frames are masked, so real frames do not move).
    Returns (B, T, mel) in mu's dtype."""
    b, t = mu.shape[0], mu.shape[1]
    mel_dim = dit.cfg.mel_dim
    dev, dtype = mu.device, mu.dtype
    if noise is None:
        noise = torch.randn((b, t, mel_dim), generator=generator, device=dev, dtype=torch.float32)
    elif tuple(noise.shape) != (b, t, mel_dim):
        raise ValueError(f"noise: shape {tuple(noise.shape)}, expected {(b, t, mel_dim)}")
    x = (noise.to(dev).float() * temperature).to(dtype)
    prompt_len = prompt.shape[1]
    prompt_x = F.pad(prompt.to(dtype), (0, 0, 0, t - prompt_len))
    t_real = t
    if pad_t_to and t % pad_t_to:
        t_pad = -t % pad_t_to
        x, prompt_x, mu = (F.pad(a, (0, 0, 0, t_pad)) for a in (x, prompt_x, mu))
        t += t_pad
    region = (torch.arange(t, device=dev) < prompt_len)[None, :, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    x = torch.where(region, zero, x)
    mask = torch.arange(t, device=dev)[None, :] < x_lens.to(dev)[:, None]
    d = 1.0 / n_steps
    d_vec = torch.full((b,), d, dtype=dtype, device=dev)

    v0, text_embed = dit(x, prompt_x, torch.zeros((b,), dtype=dtype, device=dev), d_vec, mu, mask)
    neg_text_embed = None
    if cfg_rate > 1e-5:
        n0, neg_text_embed = dit(x, prompt_x, torch.zeros((b,), dtype=dtype, device=dev), d_vec, mu, mask,
                                 drop_audio_cond=True, drop_text=True)
        v0 = v0 + (v0 - n0) * cfg_rate
    x = torch.where(region, zero, x + d * v0)
    for i in range(1, n_steps):
        t_vec = torch.full((b,), i * d, dtype=dtype, device=dev)
        v, _ = dit(x, prompt_x, t_vec, d_vec, mu, mask, text_embed_cache=text_embed)
        if neg_text_embed is not None:
            n, _ = dit(x, prompt_x, t_vec, d_vec, mu, mask, drop_audio_cond=True, text_embed_cache=neg_text_embed)
            v = v + (v - n) * cfg_rate
        x = torch.where(region, zero, x + d * v)
    return x[:, :t_real]
