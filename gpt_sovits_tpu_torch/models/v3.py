"""v3/v4 synthesizer: semantic codes -> CFM flow-matching mel
(port of gpt_sovits_tpu/models/v3.py; reference `SynthesizerTrnV3` and `CFM`,
module/models.py:1013-1275).

Shares TextEncoder, MelStyleEncoder and the VQ codebook with the v2 stack,
and adds the bridge (1x1 conv + leaky_relu 0.01 to 512 channels), nearest
interpolation x1.875 (v3) or x2 (v4), the WN encoder `wns1` and the CFM's
DiT estimator. `cfm_inference` is the Euler sampler with the text
conditioner computed once (step 0). Public tensors are feature-last as in
the JAX package; parameter names are the reference's, with weight norm
folded at load. `SynthesizerTrnV3.forward` is the training loss (through
`CFM.loss`), and `SynthesizerTrnV3b` (with `decode_encp`) has no driver, as
in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gpt_sovits_tpu_torch import at_least_f32
from gpt_sovits_tpu_torch.models.dit import DiT, DiTConfig
from gpt_sovits_tpu_torch.models.vits import Generator, PosteriorEncoder, TextEncoder, fold_weight_norm, slice_segments
from gpt_sovits_tpu_torch.models.vits_modules import (
    WN, Conv1d, MelStyleEncoder, ResidualCouplingBlock, VQCodebook, sequence_mask,
)
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


def draw_cfm(b: int, t: int, mel_dim: int, generator: torch.Generator | None = None) -> dict:
    """One training step's CFM draws on the CPU, as the JAX package draws
    them (models/v3.py:158-160, 342-353): prompt_u (B,) uniform (the prompt's
    share of 2/3 of each mel), tt (B,) uniform flow times, x0 (B, T, mel)
    noise, use_boot (a 0-d bool, 30% True) and base (B,) in [2, 8)."""
    return {"prompt_u": torch.rand(b, generator=generator), "tt": torch.rand(b, generator=generator),
            "x0": torch.randn((b, t, mel_dim), generator=generator),
            "use_boot": torch.rand((), generator=generator) < 0.3,
            "base": torch.randint(2, 8, (b,), generator=generator)}


def prompt_lengths(mel_lengths, prompt_u):
    """The random prompt prefix: prompt_u * (mel_len * 2 // 3), truncated, in
    float32 as the JAX package computes it."""
    prompt_max = (mel_lengths * 2) // 3
    return (prompt_u.to(mel_lengths.device, torch.float32) * prompt_max.float()).long()


class CFM(nn.Module):
    """Conditional flow matching over the DiT estimator (models.py:1013)."""

    def __init__(self, dit_cfg: DiTConfig):
        super().__init__()
        self.estimator = DiT(dit_cfg)

    def loss(self, x1, x_lens, prompt_lens, mu, draws: dict):
        """The flow-matching MSE (models.py:1089-1123). x1 (B, T, mel) the
        normalized target mel, x_lens and prompt_lens (B,), mu (B, T, 512)
        the conditioning, `draws` as draw_cfm's (x0 of x1's shape). The
        prompt region [0, prompt_len) is zeroed in x_t and copied into the
        condition; with use_boot the target is the mean velocity of two
        gradient-free estimator calls at d = 1/2**base (step-size input 0
        where d < 1e-2) and the step size 2d, else x1 - x0 at step size 0.
        -> the mean over the batch of each sequence's MSE over
        [prompt_len, x_len)."""
        b, t, _ = x1.shape
        dev, dtype = x1.device, x1.dtype
        tt = draws["tt"].to(dev, dtype)
        x0 = draws["x0"].to(dev, dtype)
        vt = x1 - x0
        xt = x0 + tt[:, None, None] * vt
        ar = torch.arange(t, device=dev)
        prompt_region = (ar[None, :] < prompt_lens.to(dev)[:, None])[..., None]
        zero = torch.zeros((), dtype=dtype, device=dev)
        prompt = torch.where(prompt_region, x1, zero)
        xt = torch.where(prompt_region, zero, xt)
        mask = ar[None, :] < x_lens.to(dev)[:, None]
        if bool(draws["use_boot"]):
            d = 1.0 / (2.0 ** draws["base"].to(dev, dtype))
            d_input = torch.where(d < 1e-2, zero, d)
            with torch.no_grad():
                v1, _ = self.estimator(xt, prompt, tt, d_input, mu, mask)
                v2, _ = self.estimator(xt + d[:, None, None] * v1, prompt, tt + d, d_input, mu, mask)
            target, dt = (v1 + v2) / 2.0, 2.0 * d
        else:
            target, dt = vt, torch.zeros_like(tt)
        v_pred, _ = self.estimator(xt, prompt, tt, dt, mu, mask)
        region = (~prompt_region[..., 0] & mask).to(dtype)
        sq = ((v_pred - target) ** 2).mean(dim=-1)
        per_seq = (sq * region).sum(dim=1) / torch.clamp_min(region.sum(dim=1), 1.0)
        return per_seq.mean()


class SynthesizerTrnV3(nn.Module):
    """The v3/v4 synthesizer (models.py:1128): `decode_encp` for inference,
    `forward` for training."""

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

    def forward(self, ssl, spec, spec_lengths, mel, mel_lengths, text, text_lengths, *, draws=None,
                generator: torch.Generator | None = None):
        """The training loss (models.py:1219-1242): ssl (B, Ts, 768) at 50 Hz,
        spec (B, T, bins) for ge, mel (B, Tm, mel) normalized, text (B, Tt).
        The codes' features are decoded without gradient and repeated x2;
        enc_p, the bridge, the x1.875 / x2 interpolation and wns1 under the mel
        mask give the conditioning; mel and it are cut to the shorter. `draws`
        (draw_cfm's, x0 at that length) are drawn from `generator` unless
        given. -> the CFM loss (a 0-d tensor)."""
        y_mask = sequence_mask(spec_lengths, spec.shape[1])
        ge = self.compute_ge(spec, y_mask[:, 0])
        with torch.no_grad():
            x = self.ssl_proj(ssl.transpose(1, 2)).transpose(1, 2)
            quantized = torch.repeat_interleave(self.quantizer.decode(self.quantizer.encode(x)), 2, dim=1)
        tq = quantized.shape[1]
        qt_mask = sequence_mask(torch.clamp_max(spec_lengths, tq), tq)
        text_mask = sequence_mask(text_lengths, text.shape[1])
        _, _, _, xh = self.enc_p(quantized.transpose(1, 2), qt_mask, text, text_mask, ge.transpose(1, 2))
        fea = interpolate_nearest(self.bridge(xh).transpose(1, 2), self.interp_factor)
        mel_mask = sequence_mask(mel_lengths, fea.shape[1])
        fea = self.wns1(fea.transpose(1, 2), mel_mask, g=ge.transpose(1, 2)).transpose(1, 2)
        minn = min(mel.shape[1], fea.shape[1])
        if draws is None:
            draws = draw_cfm(mel.shape[0], minn, mel.shape[2], generator)
        prompt_lens = prompt_lengths(mel_lengths, draws["prompt_u"])
        return self.cfm.loss(mel[:, :minn], torch.clamp_max(mel_lengths, minn), prompt_lens, fea[:, :minn], draws)


class SynthesizerTrnV3b(nn.Module):
    """The hybrid GAN + CFM synthesizer (models.py:1276, JAX
    `SynthesizerTrnV3b`): the VITS stack (posterior encoder, flow, HiFiGAN
    decoder on a segment) trains with the v3 CFM mel path, and a `linear_mel`
    1x1 head adds a direct mel MSE on the wns1 features. Experimental in the
    reference; the JAX package has no trainer for it, and neither has the
    port. The x1.875 interpolation is fixed (v3's)."""

    def __init__(self, cfg: S2Config):
        super().__init__()
        c = self.cfg = cfg
        self.enc_p = TextEncoder(c)
        self.ref_dim = min(704, c.spec_channels)
        self.ref_enc = MelStyleEncoder(self.ref_dim, out_dim=c.gin_channels)
        self.dec = Generator(c)
        self.enc_q = PosteriorEncoder(c)
        self.flow = ResidualCouplingBlock(c.inter_channels, c.hidden_channels, 5, 1, 4, gin_channels=c.gin_channels)
        self.ssl_proj = nn.Conv1d(c.ssl_dim, c.ssl_dim, 2, stride=2)
        self.quantizer = VQCodebook(c.n_codes, c.ssl_dim)
        self.bridge = _Bridge(c.hidden_channels)
        self.wns1 = WNEncoder(512, 512, 5, 8, gin_channels=c.gin_channels)
        self.linear_mel = Conv1d(512, c.cfm_mel_channels, 1)
        self.cfm = CFM(self.dit_config)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Reference-named weights, weight norm folded here."""
        return super().load_state_dict(fold_weight_norm(dict(state_dict)), strict=strict, assign=assign)

    dit_config = SynthesizerTrnV3.dit_config
    compute_ge = SynthesizerTrnV3.compute_ge
    extract_latent = SynthesizerTrnV3.extract_latent

    def _fea(self, xh, mel_mask, ge):
        """enc_p's hidden (B, C, T) -> wns1 features (B, T*1.875, 512)."""
        fea = interpolate_nearest(self.bridge(xh).transpose(1, 2), 1.875)
        return self.wns1(fea.transpose(1, 2), mel_mask, g=ge.transpose(1, 2)).transpose(1, 2)

    def decode_encp(self, codes, codes_lengths, text, text_lengths, refer_spec, refer_lengths, *, ge=None):
        """models.py:1411: as SynthesizerTrnV3's, with the wns1 mask at
        codes * 2.5 * 1.5 frames. -> (fea (B, T, 512), ge (B, 1, gin), mel_len (B,))."""
        if ge is None:
            ge = self.compute_ge(refer_spec, sequence_mask(refer_lengths, refer_spec.shape[1])[:, 0])
        quantized = torch.repeat_interleave(self.quantizer.decode(codes), 2, dim=1)
        y_mask = sequence_mask(codes_lengths * 2, quantized.shape[1])
        text_mask = sequence_mask(text_lengths, text.shape[1])
        _, _, _, xh = self.enc_p(quantized.transpose(1, 2), y_mask, text, text_mask, ge.transpose(1, 2))
        mel_len = (codes_lengths.float() * 2.5 * 1.5).long()
        fea = self._fea(xh, sequence_mask(mel_len, int(quantized.shape[1] * 1.875)), ge)
        return fea, ge, mel_len

    def forward(self, ssl, spec, spec_lengths, mel, mel_lengths, text, text_lengths, *, noise=None, ids_slice=None,
                draws=None, generator: torch.Generator | None = None) -> dict:
        """models.py:1370 forward: the GAN pieces, the CFM loss and the mel
        MSE, feature-last. The posterior noise (B, T, inter), the segment
        starts (B,) and the CFM draws (draw_cfm's) are drawn from `generator`
        where not given. -> wav_hat, commit_loss, cfm_loss, mel_mse,
        ids_slice, y_mask, z, z_p, m_p, logs_p, m_q, logs_q."""
        c = self.cfg
        b, t = spec.shape[:2]
        y_mask = sequence_mask(spec_lengths, t)
        ge = self.compute_ge(spec, y_mask[:, 0])
        x = self.ssl_proj(ssl.transpose(1, 2)).transpose(1, 2)
        quantized = self.quantizer.decode(self.quantizer.encode(x))
        commit_loss = torch.mean((quantized.detach() - x) ** 2)  # as SynthesizerTrn.forward
        quantized = x + (quantized - x).detach()
        if c.freeze_quantizer:
            quantized = quantized.detach()
        quantized = torch.repeat_interleave(quantized, 2, dim=1)
        quantized = F.pad(quantized, (0, 0, 0, max(t - quantized.shape[1], 0)))[:, :t]
        text_mask = sequence_mask(text_lengths, text.shape[1])
        m_p, logs_p, y_mask, xh = self.enc_p(quantized.transpose(1, 2), y_mask, text, text_mask, ge.transpose(1, 2))
        if noise is None:
            noise = torch.randn((b, t, c.inter_channels), generator=generator)
        noise = torch.as_tensor(noise).to(spec.device, at_least_f32(spec).dtype).transpose(1, 2)
        z, m_q, logs_q = self.enc_q(spec.transpose(1, 2), y_mask, ge.transpose(1, 2), noise)
        z_p = self.flow(z, y_mask, g=ge.transpose(1, 2))
        seg = c.segment_size
        if ids_slice is None:
            max_starts = torch.clamp_min(spec_lengths.cpu() - seg, 0)
            ids_slice = (torch.rand(b, generator=generator) * (max_starts + 1)).long()
        starts = torch.clamp(torch.as_tensor(ids_slice).to(spec.device).long(), 0, max(t - seg, 0))
        fl = lambda a: a.transpose(1, 2)  # noqa: E731
        wav_hat = self.dec(slice_segments(fl(z), starts, seg), g=ge)

        fea = self._fea(xh, sequence_mask(mel_lengths, int(t * 1.875)), ge)
        learned_mel = self.linear_mel(fea.transpose(1, 2)).transpose(1, 2)
        minn = min(mel.shape[1], fea.shape[1])
        if draws is None:
            draws = draw_cfm(b, minn, mel.shape[2], generator)
        prompt_lens = prompt_lengths(mel_lengths, draws["prompt_u"])
        cfm_loss = self.cfm.loss(mel[:, :minn], torch.clamp_max(mel_lengths, minn), prompt_lens, fea[:, :minn], draws)
        mel_mse = torch.mean((learned_mel[:, :minn] - mel[:, :minn]) ** 2)
        return {"wav_hat": wav_hat, "commit_loss": commit_loss, "cfm_loss": cfm_loss, "mel_mse": mel_mse,
                "ids_slice": starts, "y_mask": fl(y_mask), "z": fl(z), "z_p": fl(z_p), "m_p": fl(m_p),
                "logs_p": fl(logs_p), "m_q": fl(m_q), "logs_q": fl(logs_q)}


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
