"""MDX-Net vocal / de-reverb separation on the port's ONNX executor (port of
gpt_sovits_tpu/corpus/mdx.py).

The reference's tools/uvr5/mdxnet.py (`ConvTDFNetTrim`, `Predictor`,
`MDXNetDereverb`) runs an ONNX graph (uvr5_weights/onnx_dereverb_By_FoxJoy/
vocals.onnx) through onnxruntime; here utils/onnx_lite.py executes the same
file with torch on the card. The framing is ConvTDF's (mdxnet.py:37-59):
stereo folded into 4 real channels (2 channels x re/im), frequency cut to
dim_f, dim_t frames a window; the demix runs `margin`-overlapped segments
and, with `denoise`, the net on +x and -x averaged (mdxnet.py:146-152).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from gpt_sovits_tpu_torch.dsp.stft import istft_center, stft_center
from gpt_sovits_tpu_torch.utils.onnx_lite import OnnxModel


@dataclass(frozen=True)
class MDXConfig:
    dim_t_log2: int = 9  # dim_t = 2**9 = 512 frames
    dim_f: int = 3072
    n_fft: int = 6144
    hop: int = 1024
    chunks: int = 15  # seconds a demix segment
    margin: int = 44100
    denoise: bool = True
    sr: int = 44100

    @property
    def dim_t(self) -> int:
        return 2**self.dim_t_log2

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def chunk_size(self) -> int:
        return self.hop * (self.dim_t - 1)

    @property
    def trim(self) -> int:
        return self.n_fft // 2


def spec_of(x: torch.Tensor, cfg: MDXConfig) -> torch.Tensor:
    """(B, 2, chunk_size) -> (B, 4, dim_f, dim_t). mdxnet.py:37."""
    B = x.shape[0]
    z = stft_center(x.reshape(B * 2, cfg.chunk_size), cfg.n_fft, cfg.hop)[..., : cfg.dim_t]  # (B*2, F, T)
    out = torch.view_as_real(z).permute(0, 3, 1, 2).reshape(B, 4, cfg.n_bins, cfg.dim_t)
    return out[:, :, : cfg.dim_f]


def wave_of(spec: torch.Tensor, cfg: MDXConfig) -> torch.Tensor:
    """(B, 4, dim_f, dim_t) -> (B, 2, chunk_size). mdxnet.py:50."""
    B = spec.shape[0]
    spec = F.pad(spec, (0, 0, 0, cfg.n_bins - cfg.dim_f)).reshape(B * 2, 2, cfg.n_bins, cfg.dim_t)
    z = torch.complex(spec[:, 0].float(), spec[:, 1].float())
    return istft_center(z, cfg.n_fft, cfg.hop).reshape(B, 2, -1)


class MDXSeparator:
    def __init__(self, onnx_path: str, cfg: MDXConfig = MDXConfig(), device=None):
        self.cfg = cfg
        self.model = OnnxModel.from_file(onnx_path, device=device)
        self.device = self.model.device
        (self.in_name,) = self.model.input_names or ["input"]

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 2, chunk) -> (B, 2, chunk) target stem."""
        cfg = self.cfg
        spek = spec_of(x.to(self.device), cfg)
        if cfg.denoise:
            pred = -self.model.run({self.in_name: -spek})[0] * 0.5 + self.model.run({self.in_name: spek})[0] * 0.5
        else:
            pred = self.model.run({self.in_name: spek})[0]
        return wave_of(pred, cfg)

    def demix_segment(self, cmix: np.ndarray) -> np.ndarray:
        """(2, n) -> (2, n) target stem for one margin-padded segment."""
        cfg = self.cfg
        n_sample = cmix.shape[1]
        trim = cfg.trim
        gen_size = cfg.chunk_size - 2 * trim
        pad = gen_size - n_sample % gen_size
        z = lambda n: np.zeros((2, n), np.float32)  # noqa: E731
        mix_p = np.concatenate([z(trim), cmix.astype(np.float32), z(pad), z(trim)], axis=1)
        waves = []
        i = 0
        while i < n_sample + pad:
            waves.append(mix_p[:, i: i + cfg.chunk_size])
            i += gen_size
        tar = self.forward(torch.from_numpy(np.stack(waves))).cpu().numpy()  # (n_win, 2, chunk)
        tar = tar[:, :, trim:-trim].transpose(1, 0, 2).reshape(2, -1)
        return tar[:, :-pad]

    def demix(self, mix: np.ndarray) -> np.ndarray:
        """(2, L) -> (2, L) target stem; mdxnet.py:92 margin chunking."""
        cfg = self.cfg
        samples = mix.shape[-1]
        margin = min(cfg.margin, cfg.chunks * cfg.sr) or cfg.sr
        chunk = cfg.chunks * cfg.sr
        if cfg.chunks == 0 or samples < chunk:
            chunk = samples
        segments, locs = [], []
        skip = 0
        while skip < samples:
            s_margin = 0 if skip == 0 else margin
            end = min(skip + chunk + margin, samples)
            segments.append(mix[:, skip - s_margin: end])
            locs.append((skip, end == samples))
            if end == samples:
                break
            skip += chunk
        outs = []
        for seg, (skip_pos, is_last) in zip(segments, locs):
            tar = self.demix_segment(seg)
            start = 0 if skip_pos == 0 else margin
            end = None if is_last or margin == 0 else -margin
            outs.append(tar[:, start:end])
        return np.concatenate(outs, axis=-1)[:, :samples]


def separate(wav: np.ndarray, sr: int, onnx_path: str, *, cfg: MDXConfig = MDXConfig(),
             device=None) -> tuple[np.ndarray, np.ndarray]:
    """(L,) or (S, L) -> (main, separated-out stem) at the input rate.

    For the FoxJoy de-reverb model the net isolates the reverb tail:
    main = mix - pred (the reference's 'main_vocal', mdxnet.py:173-176),
    other = pred."""
    from gpt_sovits_tpu_torch.dsp.audio_io import resample as rs

    mono_in = wav.ndim == 1
    x = wav[None] if mono_in else np.asarray(wav, np.float32)
    if x.shape[0] == 1:
        x = np.repeat(x, 2, axis=0)
    if sr != cfg.sr:
        x = np.stack([rs(c, sr, cfg.sr) for c in x])

    opt = MDXSeparator(onnx_path, cfg, device).demix(x)
    main = x - opt
    if sr != cfg.sr:
        main = np.stack([rs(c, cfg.sr, sr) for c in main])
        opt = np.stack([rs(c, cfg.sr, sr) for c in opt])

    def fit(a, n):
        return a[..., :n] if a.shape[-1] >= n else np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])])

    n_in = wav.shape[-1]
    main, opt = fit(main, n_in), fit(opt, n_in)
    if mono_in:
        main, opt = main.mean(axis=0), opt.mean(axis=0)
    return main.astype(np.float32), opt.astype(np.float32)
