"""BS-RoFormer / Mel-Band RoFormer vocal separation (port of
gpt_sovits_tpu/corpus/roformer.py).

The reference's UVR5 RoFormer family (tools/uvr5/bs_roformer/bs_roformer.py
`BSRoformer`, mel_band_roformer.py `MelBandRoformer`, the loader and demixer
tools/uvr5/bsroformer.py `Roformer_Loader`): axial transformers alternating
over the time and band axes of a band-split complex STFT, predicting a
complex ratio mask per stem. The modules carry the reference's state-dict
names (`band_split.to_features.0.1.weight`, `layers.3.1.layers.0.0.to_qkv
.weight`, `mask_estimators.0.to_freqs.5.0.2.bias`, ...), so a public
`.ckpt` loads into them directly. f32, on the card unless `device="cpu"`.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gpt_sovits_tpu_torch import resolve_device
from gpt_sovits_tpu_torch.dsp.mel import mel_filterbank
from gpt_sovits_tpu_torch.dsp.stft import istft_center, stft_center

# Band layout of the public BS-RoFormer checkpoints (bsroformer.py:39).
DEFAULT_FREQS_PER_BANDS = (
    (2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8 + (128, 129)
)


@dataclass(frozen=True)
class RoformerConfig:
    kind: str = "bs"  # "bs" | "mel"
    dim: int = 512
    depth: int = 12
    stereo: bool = True
    num_stems: int = 1
    time_transformer_depth: int = 1
    freq_transformer_depth: int = 1
    linear_transformer_depth: int = 0
    freqs_per_bands: Sequence[int] = DEFAULT_FREQS_PER_BANDS  # bs only
    num_bands: int = 60  # mel only
    dim_head: int = 64
    heads: int = 8
    stft_n_fft: int = 2048
    stft_hop_length: int = 441
    stft_win_length: int = 2048
    sample_rate: int = 44100
    mask_estimator_depth: int = 2
    mlp_expansion_factor: int = 4
    skip_connection: bool = False

    @property
    def audio_channels(self) -> int:
        return 2 if self.stereo else 1

    @property
    def n_freqs(self) -> int:
        return self.stft_n_fft // 2 + 1

    def band_freq_counts(self) -> tuple[int, ...]:
        """Number of STFT bins per band (before channel/complex folding)."""
        if self.kind == "bs":
            counts = tuple(int(f) for f in self.freqs_per_bands)
            if sum(counts) != self.n_freqs:
                raise ValueError(f"freqs_per_bands sums to {sum(counts)}, need {self.n_freqs}")
            return counts
        return tuple(int(c) for c in _mel_freqs_per_band(self).sum(axis=1))

    def band_dims(self) -> tuple[int, ...]:
        return tuple(2 * f * self.audio_channels for f in self.band_freq_counts())

    @staticmethod
    def from_dict(model_cfg: dict) -> "RoformerConfig":
        kind = "bs" if "freqs_per_bands" in model_cfg else "mel"
        keys = set(RoformerConfig.__dataclass_fields__)
        kw = {k: v for k, v in model_cfg.items() if k in keys}
        if "freqs_per_bands" in kw:
            kw["freqs_per_bands"] = tuple(kw["freqs_per_bands"])
        return RoformerConfig(kind=kind, **kw)


def _mel_freqs_per_band(cfg: RoformerConfig) -> np.ndarray:
    """(num_bands, n_freqs) bool membership, mel_band_roformer.py:358-374."""
    fb = mel_filterbank(cfg.sample_rate, cfg.stft_n_fft, cfg.num_bands, 0.0, None).astype(np.float64)
    fb[0, 0] = 1.0
    fb[-1, -1] = 1.0
    mask = fb > 0
    if not mask.any(axis=0).all():
        raise ValueError("mel filterbank leaves uncovered frequencies")
    return mask


def _mel_indices(cfg: RoformerConfig) -> tuple[np.ndarray, np.ndarray]:
    """(freq indices folded with the channels, band-major; the number of
    bands covering each folded frequency)."""
    mask = _mel_freqs_per_band(cfg)
    idx = np.concatenate([np.nonzero(row)[0] for row in mask])
    if cfg.stereo:
        idx = (idx[:, None] * 2 + np.arange(2)[None, :]).reshape(-1)
    denom = np.repeat(mask.sum(axis=0), cfg.audio_channels).astype(np.float32)
    return idx.astype(np.int64), denom


class RMSNorm(nn.Module):
    """bs_roformer.py:46: F.normalize(x) * sqrt(dim) * gamma (eps 1e-12)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim**0.5
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.normalize(x, dim=-1) * self.scale * self.gamma


@functools.lru_cache(maxsize=16)
def _rotary_table(n: int, dh: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (n, dh) for positions 0..n-1, each frequency repeated for its
    interleaved pair (rotary_embedding_torch's default, theta 10000)."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dh, 2) / dh))
    freqs = np.repeat(np.arange(n)[:, None] * inv_freq[None, :], 2, axis=-1).astype(np.float32)
    return torch.from_numpy(np.cos(freqs)).to(device), torch.from_numpy(np.sin(freqs)).to(device)


def rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...): pairs are adjacent."""
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor) -> torch.Tensor:
    """Rotary embedding along axis -2 (positions 0..N-1) of (..., N, dh)."""
    cos, sin = _rotary_table(x.shape[-2], x.shape[-1], x.device)
    return x * cos + rotate_half_interleaved(x) * sin


class Attention(nn.Module):
    """Gated softmax attention with rotary q/k (bs_roformer.py:76)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_gates = nn.Linear(dim, heads)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim, bias=False), nn.Dropout(0.0))

    def forward(self, x):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        y = self.norm(x)
        q, k, v = self.to_qkv(y).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(apply_rotary(q), apply_rotary(k), v)
        out = out * torch.sigmoid(self.to_gates(y)).transpose(1, 2)[..., None]
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(RMSNorm(dim), nn.Linear(dim, dim * mult), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(dim * mult, dim), nn.Dropout(0.0))

    def forward(self, x):
        return self.net(x)


class Transformer(nn.Module):
    """norm_output=False in the bs variant (its final_norm is applied once at
    the end), True (an output RMSNorm a block) in the mel variant."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, norm_output: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([Attention(dim, heads, dim_head), FeedForward(dim)])
                                    for _ in range(depth))
        self.norm = RMSNorm(dim) if norm_output else nn.Identity()

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return self.norm(x)


class BandSplit(nn.Module):
    def __init__(self, dim: int, dim_inputs: Sequence[int]):
        super().__init__()
        self.dim_inputs = tuple(dim_inputs)
        self.to_features = nn.ModuleList(nn.Sequential(RMSNorm(d), nn.Linear(d, dim)) for d in self.dim_inputs)

    def forward(self, x):
        """(B, T, sum dims) -> (B, T, n_bands, dim)."""
        return torch.stack([f(seg) for seg, f in zip(x.split(self.dim_inputs, dim=-1), self.to_features)], dim=-2)


class MaskEstimator(nn.Module):
    """A per-band MLP (n_hidden tanh layers of dim * expansion) and a GLU.
    bs_roformer.py:216 gives the bs variant mask_estimator_depth - 1 hidden
    layers, the mel file's MLP one more."""

    def __init__(self, dim: int, dim_inputs: Sequence[int], n_hidden: int, expansion: int):
        super().__init__()
        hidden = dim * expansion
        nets = []
        for d in dim_inputs:
            dims = (dim,) + (hidden,) * n_hidden + (2 * d,)
            mlp = []
            for j, (i_, o_) in enumerate(zip(dims[:-1], dims[1:])):
                mlp.append(nn.Linear(i_, o_))
                if j < n_hidden:
                    mlp.append(nn.Tanh())
            nets.append(nn.Sequential(nn.Sequential(*mlp), nn.GLU(dim=-1)))
        self.to_freqs = nn.ModuleList(nets)

    def forward(self, x):
        """(B, T, n_bands, dim) -> (B, T, sum dims)."""
        return torch.cat([f(x[..., i, :]) for i, f in enumerate(self.to_freqs)], dim=-1)


class Roformer(nn.Module):
    """One separation forward on a chunk: (B, S, L) waveform -> (B, num_stems, S, L)."""

    def __init__(self, cfg: RoformerConfig):
        super().__init__()
        if cfg.linear_transformer_depth:
            raise NotImplementedError("linear transformer stages are unused by the product checkpoints")
        self.cfg = cfg
        dims = cfg.band_dims()
        no = cfg.kind == "mel"
        self.band_split = BandSplit(cfg.dim, dims)
        self.layers = nn.ModuleList(nn.ModuleList([
            Transformer(cfg.dim, cfg.time_transformer_depth, cfg.heads, cfg.dim_head, no),
            Transformer(cfg.dim, cfg.freq_transformer_depth, cfg.heads, cfg.dim_head, no),
        ]) for _ in range(cfg.depth))
        if cfg.kind == "bs":
            self.final_norm = RMSNorm(cfg.dim)
        n_hidden = cfg.mask_estimator_depth - (1 if cfg.kind == "bs" else 0)
        self.mask_estimators = nn.ModuleList(MaskEstimator(cfg.dim, dims, n_hidden, cfg.mlp_expansion_factor)
                                             for _ in range(cfg.num_stems))
        if cfg.kind == "mel":
            idx, denom = _mel_indices(cfg)
            self.register_buffer("freq_indices", torch.from_numpy(idx), persistent=False)
            self.register_buffer("num_bands_per_freq", torch.from_numpy(denom), persistent=False)

    def forward(self, raw_audio: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, L = raw_audio.shape
        assert S == cfg.audio_channels, (S, cfg.audio_channels)
        z = stft_center(raw_audio.reshape(B * S, L), cfg.stft_n_fft, cfg.stft_hop_length, cfg.stft_win_length)
        F_, T = z.shape[-2], z.shape[-1]
        z = z.reshape(B, S, F_, T).transpose(1, 2).reshape(B, F_ * S, T)  # channels folded into frequency, f-major
        zx = z[:, self.freq_indices] if cfg.kind == "mel" else z
        x = torch.view_as_real(zx).permute(0, 2, 1, 3).reshape(B, T, -1)  # (B, T, (f s c))

        x = self.band_split(x)
        store = []
        for time_tr, freq_tr in self.layers:
            if cfg.skip_connection:
                for prev in store:
                    x = x + prev
            nb = x.shape[-2]
            xt = time_tr(x.transpose(1, 2).reshape(B * nb, T, cfg.dim))  # attention over time
            x = xt.reshape(B, nb, T, cfg.dim).transpose(1, 2)
            x = freq_tr(x.reshape(B * T, nb, cfg.dim)).reshape(B, T, nb, cfg.dim)  # over bands
            if cfg.skip_connection:
                store.append(x)
        if cfg.kind == "bs":
            x = self.final_norm(x)

        masks = [torch.view_as_complex(m(x).reshape(B, T, -1, 2).contiguous()).transpose(1, 2)
                 for m in self.mask_estimators]
        mask = torch.stack(masks, dim=1)  # (B, N, F', T)
        if cfg.kind == "mel":
            summed = torch.zeros((B, cfg.num_stems, F_ * S, T), dtype=mask.dtype, device=mask.device)
            summed.index_add_(2, self.freq_indices, mask)
            mask = summed / self.num_bands_per_freq.clamp_min(1e-8)[None, None, :, None]

        out = z[:, None] * mask  # (B, N, (f s), T)
        out = out.reshape(B, cfg.num_stems, F_, S, T).transpose(2, 3).reshape(B * cfg.num_stems * S, F_, T)
        wav = istft_center(out, cfg.stft_n_fft, cfg.stft_hop_length, cfg.stft_win_length, length=L)
        return wav.reshape(B, cfg.num_stems, S, L)


# ---------------------------------------------------------------------------
# Chunked demix (fade-window overlap-add; bsroformer.py:111 demix_track)
# ---------------------------------------------------------------------------


def demix(apply_fn, mix: np.ndarray, *, chunk_size: int = 352800, num_overlap: int = 2, batch_size: int = 2,
          num_stems: int = 1) -> np.ndarray:
    """apply_fn: (B, S, chunk) float32 tensor -> (B, N, S, chunk) tensor.

    mix (S, L) -> (N, S, L). Reflect-pads `border` on both ends, runs
    chunks of `chunk_size` in batches of up to `batch_size`; fade-in/out
    windows and a counter normalise the overlap-add. (The fade window is
    chosen per chunk, as in the JAX package.)
    """
    C = chunk_size
    step = C // num_overlap
    border = C - step
    fade = C // 10
    S, length_init = mix.shape
    if length_init > 2 * border and border > 0:
        mix = np.pad(mix, ((0, 0), (border, border)), mode="reflect")

    w_start, w_mid, w_fin = np.ones(C), np.ones(C), np.ones(C)
    w_start[-fade:] = np.linspace(1, 0, fade)
    w_fin[:fade] = np.linspace(0, 1, fade)
    w_mid[-fade:] = np.linspace(1, 0, fade)
    w_mid[:fade] = np.linspace(0, 1, fade)

    result = np.zeros((num_stems, S, mix.shape[-1]), np.float32)
    counter = np.zeros_like(result)
    batch, locs = [], []
    i = 0
    total = mix.shape[-1]
    while i < total:
        part = mix[:, i: i + C]
        ln = part.shape[-1]
        if ln < C:
            part = np.pad(part, ((0, 0), (0, C - ln)), mode="reflect" if ln > C // 2 + 1 else "constant")
        batch.append(part)
        locs.append((i, ln))
        i += step
        if len(batch) >= batch_size or i >= total:
            with torch.no_grad():
                out = apply_fn(torch.from_numpy(np.stack(batch).astype(np.float32))).float().cpu().numpy()
            for j, (start, ln) in enumerate(locs):
                if start == 0:
                    w = w_start
                elif i >= total and j == len(locs) - 1:
                    w = w_fin
                else:
                    w = w_mid
                result[..., start: start + ln] += out[j][..., :ln] * w[:ln]
                counter[..., start: start + ln] += w[:ln]
            batch, locs = [], []

    est = np.nan_to_num(result / np.maximum(counter, 1e-10), nan=0.0)
    if length_init > 2 * border and border > 0:
        est = est[..., border:-border]
    return est


# ---------------------------------------------------------------------------
# Loader / one-call separation (tools/uvr5/bsroformer.py Roformer_Loader)
# ---------------------------------------------------------------------------

# Defaults for checkpoints shipped without a YAML (bsroformer.py:23-95).
DEFAULT_BS_AUDIO = {"chunk_size": 352800, "sample_rate": 44100}
DEFAULT_BS_INFER = {"batch_size": 2, "num_overlap": 2}
DEFAULT_MEL_MODEL = dict(
    dim=384, depth=12, stereo=True, num_stems=1,
    time_transformer_depth=1, freq_transformer_depth=1, num_bands=60,
    dim_head=64, heads=8, sample_rate=44100,
    stft_n_fft=2048, stft_hop_length=441, stft_win_length=2048,
    mask_estimator_depth=2,
)
DEFAULT_BS_MODEL = dict(
    dim=512, depth=12, stereo=True, num_stems=1,
    time_transformer_depth=1, freq_transformer_depth=1,
    freqs_per_bands=DEFAULT_FREQS_PER_BANDS,
    dim_head=64, heads=8,
    stft_n_fft=2048, stft_hop_length=441, stft_win_length=2048,
    mask_estimator_depth=2,
)

# entries of a reference state dict that are fixed tables, not weights: the
# rotary frequencies (rotary_embedding_torch keeps them as a Parameter) and
# the mel variant's band indices; the port computes its own
_TABLES = ("rotary_embed.freqs", "rotary_embed.inv_freq", "freq_indices", "num_bands_per_freq")


def load_roformer_state(model: Roformer, state_dict: dict) -> None:
    """Strict load of a reference state dict, its fixed tables left out."""
    sd = {k: v for k, v in state_dict.items() if not k.endswith(_TABLES)}
    model.load_state_dict({k: torch.as_tensor(v).float() for k, v in sd.items()}, strict=True)


def load_roformer(model_path: str, config_path: Optional[str] = None, device=None):
    """-> (Roformer in eval mode on `device`, audio cfg dict, inference cfg dict).
    PyYAML is imported only when a config file is given."""
    from gpt_sovits_tpu_torch.train.ckpt import load_torch_checkpoint

    dev = resolve_device(device)
    name = os.path.basename(model_path).lower()
    is_mel = "mel_band_roformer" in name or "melbandroformer" in name
    audio, infer = dict(DEFAULT_BS_AUDIO), dict(DEFAULT_BS_INFER)
    if config_path and os.path.exists(config_path):
        import yaml

        with open(config_path, encoding="utf-8") as f:
            y = yaml.load(f, Loader=yaml.FullLoader)
        model_cfg = dict(y["model"])
        audio.update(y.get("audio", {}))
        infer.update(y.get("inference", {}))
    else:
        model_cfg = dict(DEFAULT_MEL_MODEL if is_mel else DEFAULT_BS_MODEL)
    cfg = RoformerConfig.from_dict(model_cfg)
    sd = load_torch_checkpoint(model_path)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = Roformer(cfg)
    load_roformer_state(model, sd)
    return model.to(dev).eval(), audio, infer


def _fit(a: np.ndarray, n: int) -> np.ndarray:
    """Double resampling can drift by a sample: pin to the input length."""
    return a[..., :n] if a.shape[-1] >= n else np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])])


def separate(wav: np.ndarray, sr: int, model_path: str, *, config_path: Optional[str] = None,
             device=None) -> tuple[np.ndarray, np.ndarray]:
    """(L,) or (S, L) waveform -> (vocals, other) at the input rate."""
    from gpt_sovits_tpu_torch.dsp.audio_io import resample

    model, audio, infer = load_roformer(model_path, config_path, device)
    cfg = model.cfg
    dev = next(model.parameters()).device
    model_sr = audio.get("sample_rate", 44100)

    mono_in = wav.ndim == 1
    x = wav[None, :] if mono_in else np.asarray(wav, np.float32)
    if sr != model_sr:
        x = np.stack([resample(c, sr, model_sr) for c in x])
    if cfg.stereo and x.shape[0] == 1:
        x = np.repeat(x, 2, axis=0)
    if not cfg.stereo and x.shape[0] > 1:
        x = x.mean(axis=0, keepdims=True)

    est = demix(lambda w: model(w.to(dev)), x, chunk_size=int(audio.get("chunk_size", 352800)),
                num_overlap=int(infer.get("num_overlap", 2)), batch_size=int(infer.get("batch_size", 2)),
                num_stems=cfg.num_stems)
    vocals = est[0]
    other = x - vocals
    if sr != model_sr:
        vocals = np.stack([resample(c, model_sr, sr) for c in vocals])
        other = np.stack([resample(c, model_sr, sr) for c in other])
    n_in = wav.shape[-1]
    vocals, other = _fit(vocals, n_in), _fit(other, n_in)
    if mono_in:
        vocals, other = vocals.mean(axis=0), other.mean(axis=0)
    return vocals.astype(np.float32), other.astype(np.float32)
