"""FRCRN speech denoiser (port of gpt_sovits_tpu/models/frcrn.py).

The reference's denoise tool is the modelscope FRCRN pipeline
(tools/cmd-denoise.py, model `damo/speech_frcrn_ans_cirm_16k`): a complex
U-Net with frequency recurrence through FSMN layers, estimating a
tanh-bounded complex ratio mask, two U-Nets cascaded (Zhao et al., ICASSP
2022). `FRCRNConfig()` is the published checkpoint's configuration: 16 kHz,
STFT win 640 / hop 320 / fft 640 with a sqrt-Hann window, complexity 45.

Layout: a complex feature map is one tensor (2, B, C, F, T), index 0 the
real part, 1 the imaginary part; each complex convolution runs its real and
imaginary kernels once over both parts stacked along the batch. The state
dict's names are the checkpoint's (`unet.enc_0.real.weight`,
`unet.enc_bn_0.imag.running_mean`, `unet.fsmn_0.re_mem.weight`,
`unet2.dec_5.imag.bias`, ...), the names models/frcrn.py's importer reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gpt_sovits_tpu_torch import resolve_device

# ---------------------------------------------------------------------------
# STFT / iSTFT (modelscope conv_stft.py math: a framed rfft under a sqrt-Hann
# window, no centring: win_len//2 zeros on both sides)
# ---------------------------------------------------------------------------


def _sqrt_hann(n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.sqrt(np.hanning(n + 1)[:-1]).astype(np.float32)).to(device)


def frcrn_stft(wav: torch.Tensor, win_len: int = 640, hop: int = 320, fft_len: int = 640):
    """(B, L) -> (real, imag), each (B, F, T), F = fft_len//2+1."""
    pad = win_len // 2
    frames = F.pad(wav, (pad, pad)).unfold(-1, win_len, hop) * _sqrt_hann(win_len, wav.device)
    z = torch.fft.rfft(frames, n=fft_len, dim=-1)
    return z.real.transpose(1, 2), z.imag.transpose(1, 2)


def frcrn_istft(re: torch.Tensor, im: torch.Tensor, length: int, win_len: int = 640, hop: int = 320,
                fft_len: int = 640) -> torch.Tensor:
    """Inverse of frcrn_stft: windowed 50%-hop overlap-add. The window's
    square is a Hann, which sums to 1 at 50% hop on the interior; the
    win_len//2 edge samples fall in the stripped padding."""
    assert win_len == 2 * hop, "50% hop assumed (the checkpoint's 640/320)"
    z = torch.complex(re, im).transpose(1, 2)
    frames = torch.fft.irfft(z, n=fft_len, dim=-1)[..., :win_len] * _sqrt_hann(win_len, re.device)
    b, n_frames, _ = frames.shape
    out = F.pad(frames[:, :, :hop], (0, 0, 0, 1)) + F.pad(frames[:, :, hop:], (0, 0, 1, 0))
    out = out.reshape(b, (n_frames + 1) * hop)
    pad = win_len // 2
    return out[:, pad: pad + length]


# ---------------------------------------------------------------------------
# Complex building blocks: (Wr + iWi)(xr + ixi); BatchNorm per component
# ---------------------------------------------------------------------------


def _complex_apply(real: nn.Module, imag: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x (2, B, ...) -> (2, B, ...): yr = r(xr) - i(xi), yi = r(xi) + i(xr)."""
    b = x.shape[1]
    flat = x.flatten(0, 1)
    a, c = real(flat), imag(flat)
    a, c = a.reshape(2, b, *a.shape[1:]), c.reshape(2, b, *c.shape[1:])
    return torch.stack([a[0] - c[1], a[1] + c[0]])


class ComplexConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=(1, 1), padding=(0, 0)):
        super().__init__()
        self.real = nn.Conv2d(cin, cout, kernel, stride, padding)
        self.imag = nn.Conv2d(cin, cout, kernel, stride, padding)

    def forward(self, x):  # (2, B, C, F, T)
        return _complex_apply(self.real, self.imag, x)


class ComplexConvTranspose2d(nn.Module):
    """torch's ConvTranspose2d(padding=p, output_padding=op): out size
    (i-1)s - 2p + k + op; JAX's lax.conv_transpose pads the dilated input by
    (k-1-p, k-1-p+op) to the same effect."""

    def __init__(self, cin: int, cout: int, kernel, stride=(1, 1), padding=(0, 0), output_padding=(0, 0)):
        super().__init__()
        self.real = nn.ConvTranspose2d(cin, cout, kernel, stride, padding, output_padding)
        self.imag = nn.ConvTranspose2d(cin, cout, kernel, stride, padding, output_padding)

    def forward(self, x):
        return _complex_apply(self.real, self.imag, x)


class ComplexBatchNorm(nn.Module):
    """Independent real/imag BatchNorm2d (flax momentum 0.9 = torch 0.1)."""

    def __init__(self, c: int):
        super().__init__()
        self.real = nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)
        self.imag = nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return torch.stack([self.real(x[0]), self.imag(x[1])])


class ComplexFSMN(nn.Module):
    """Frequency recurrence (modelscope ComplexUniDeepFsmn) along the
    frequency axis: a causal depthwise memory of `lorder` taps over F, with
    a residual skip. in/out (2, B, C, F, T)."""

    def __init__(self, c: int, hidden: int, out_dim: int, lorder: int = 20):
        super().__init__()
        self.lorder = lorder
        for br in ("re", "im"):
            setattr(self, f"{br}_lin1", nn.Linear(c, hidden))
            setattr(self, f"{br}_proj", nn.Linear(hidden, out_dim, bias=False))
            setattr(self, f"{br}_mem", nn.Conv1d(out_dim, out_dim, lorder, groups=out_dim, bias=False))
            setattr(self, f"{br}_lin2", nn.Linear(out_dim, hidden))
            setattr(self, f"{br}_out", nn.Linear(hidden, out_dim))

    def _branch(self, br: str, h: torch.Tensor) -> torch.Tensor:  # (N, F, C)
        p = getattr(self, f"{br}_proj")(torch.relu(getattr(self, f"{br}_lin1")(h)))
        mem = getattr(self, f"{br}_mem")(F.pad(p.transpose(1, 2), (self.lorder - 1, 0)))
        p = p + mem.transpose(1, 2)  # causal memory along F
        return getattr(self, f"{br}_out")(torch.relu(getattr(self, f"{br}_lin2")(p)))

    def forward(self, x):
        _, b, c, f, t = x.shape
        seq = x.permute(0, 1, 4, 3, 2).reshape(2, b * t, f, c)  # F is the sequence axis
        yr = self._branch("re", seq[0]) - self._branch("im", seq[1])
        yi = self._branch("re", seq[1]) + self._branch("im", seq[0])
        y = torch.stack([yr, yi]).reshape(2, b, t, f, -1).permute(0, 1, 4, 3, 2)
        return x + y


# ---------------------------------------------------------------------------
# Complex U-Net: frequency-downsampling encoders, FSMN bottleneck, skip-
# connected decoders
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FRCRNConfig:
    win_len: int = 640
    hop: int = 320
    fft_len: int = 640
    complexity: int = 45  # base channel count of the published checkpoint
    channels: tuple = (1, 2, 2, 2, 2, 2)  # encoder widths as multiples of `complexity`; decoders mirror
    kernel: tuple = (5, 3)
    fsmn_hidden: int = 128
    fsmn_lorder: int = 20
    fsmn_layers: int = 2
    leak: float = 0.1


class ComplexUNet(nn.Module):
    def __init__(self, cfg: FRCRNConfig):
        super().__init__()
        self.cfg = c = cfg
        kf, kt = c.kernel
        pad = (kf // 2, kt // 2)
        widths = [m * c.complexity for m in c.channels]
        cin = 1
        for i, w in enumerate(widths):
            setattr(self, f"enc_{i}", ComplexConv2d(cin, w, c.kernel, (2, 1), pad))
            setattr(self, f"enc_bn_{i}", ComplexBatchNorm(w))
            cin = w
        for i in range(c.fsmn_layers):
            setattr(self, f"fsmn_{i}", ComplexFSMN(widths[-1], c.fsmn_hidden, widths[-1], c.fsmn_lorder))
        for i in reversed(range(len(widths))):
            out_ch = widths[i - 1] if i > 0 else 1
            setattr(self, f"dec_{i}", ComplexConvTranspose2d(2 * widths[i], out_ch, c.kernel, (2, 1), pad, (1, 0)))
            if i > 0:
                setattr(self, f"dec_bn_{i}", ComplexBatchNorm(out_ch))

    def forward(self, x):  # (2, B, 1, F, T) -> same
        c = self.cfg
        skips = []
        h = x
        for i in range(len(c.channels)):
            h = getattr(self, f"enc_bn_{i}")(getattr(self, f"enc_{i}")(h))
            h = F.leaky_relu(h, c.leak)
            skips.append(h)
        for i in range(c.fsmn_layers):
            h = getattr(self, f"fsmn_{i}")(h)
        for i in reversed(range(len(c.channels))):
            h = getattr(self, f"dec_{i}")(torch.cat([h, skips[i]], dim=2))
            if i > 0:
                h = F.leaky_relu(getattr(self, f"dec_bn_{i}")(h), c.leak)
        return h


class FRCRN(nn.Module):
    """Two cascaded complex U-Nets estimating a complex ratio mask
    (mask = tanh(unet(spec)) + tanh(unet2(unet(spec)))), applied to the
    spectrogram by complex multiplication."""

    def __init__(self, cfg: FRCRNConfig = FRCRNConfig()):
        super().__init__()
        self.cfg = cfg
        self.unet = ComplexUNet(cfg)
        self.unet2 = ComplexUNet(cfg)

    def forward(self, wav: torch.Tensor):
        """(B, L) noisy 16 kHz waveform -> (denoised (B, L), (mask_re, mask_im) each (B, F, T))."""
        c = self.cfg
        length = wav.shape[-1]
        re, im = frcrn_stft(wav, c.win_len, c.hop, c.fft_len)
        f0 = re.shape[1]
        f_pad = -f0 % (2 ** len(c.channels))  # the encoder strides halve F at every stage
        spec = F.pad(torch.stack([re, im]), (0, 0, 0, f_pad))[:, :, None]  # (2, B, 1, F', T)
        u1 = self.unet(spec)
        m1 = torch.tanh(u1)
        m2 = torch.tanh(self.unet2(u1)) + m1
        mr, mi = m2[0, :, 0, :f0], m2[1, :, 0, :f0]
        est_r = re * mr - im * mi
        est_i = re * mi + im * mr
        return frcrn_istft(est_r, est_i, length, c.win_len, c.hop, c.fft_len), (mr, mi)


# ---------------------------------------------------------------------------
# Losses (SI-SNR training objective)
# ---------------------------------------------------------------------------


def si_snr(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB, per batch row."""
    ref = ref - ref.mean(-1, keepdim=True)
    est = est - est.mean(-1, keepdim=True)
    proj = (torch.sum(est * ref, -1, keepdim=True) / (torch.sum(ref * ref, -1, keepdim=True) + eps)) * ref
    noise = est - proj
    return 10.0 * torch.log10((torch.sum(proj**2, -1) + eps) / (torch.sum(noise**2, -1) + eps))


def frcrn_loss(wav_hat: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    return -torch.mean(si_snr(wav_hat, clean))


# ---------------------------------------------------------------------------
# Checkpoint import (modelscope pytorch_model.bin, names as the module tree)
# ---------------------------------------------------------------------------


def load_frcrn_state(model: FRCRN, state_dict: dict) -> None:
    """Load a checkpoint's tensors (a `model.` prefix accepted) strictly: a
    missing key raises KeyError, an unknown key or a shape that differs
    ValueError. BatchNorm's num_batches_tracked may be absent."""
    sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in state_dict.items()}
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"missing checkpoint keys ({len(missing)}): {missing[:8]}")
    unknown = [k for k in sd if k not in own]
    if unknown:
        raise ValueError(f"unmapped checkpoint keys ({len(unknown)}): {unknown[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != model shape {tuple(own[k].shape)}")
    model.load_state_dict({**own, **{k: torch.as_tensor(v) for k, v in sd.items()}})


def load_frcrn(ckpt_path: str, cfg: FRCRNConfig = FRCRNConfig(), device=None) -> FRCRN:
    """A modelscope FRCRN checkpoint (pytorch_model.bin) -> the model in
    eval mode on `device` (the card unless "cpu")."""
    dev = resolve_device(device)
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    model = FRCRN(cfg)
    load_frcrn_state(model, sd)
    return model.to(dev).eval()
