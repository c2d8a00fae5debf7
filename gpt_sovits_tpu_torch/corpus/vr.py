"""UVR5 "VR" spectrogram-mask separators (port of gpt_sovits_tpu/corpus/vr.py).

The reference's VR family (tools/uvr5/vr.py `AudioPre` / `AudioPreDeEcho`;
nets lib/lib_v5/nets_61968KB.py `CascadedASPPNet` on layers_123821KB.py and
nets_new.py `CascadedNet` on layers_new.py; processing spec_utils.py;
windowed inference lib/utils.py:25):

- a 4-band multirate STFT front end (a 672-bin combined magnitude spec),
- a cascaded U-Net with ASPP (the HP family) or with a BiLSTM (DeEcho /
  DeReverb) predicting a sigmoid magnitude mask,
- the aggressiveness powers, high-end mirroring and per-band iSTFT.

The nets are `nn.Module`s under the reference's state-dict names, so the
public `.pth` files load into them as they are; BatchNorm is `nn.BatchNorm`
in eval mode (the JAX package folds it into the convolutions). The band
pipeline stays on the host (numpy/scipy, the STFTs on the CPU), as in the
reference and the JAX package; librosa's resamplers are scipy's polyphase
resampling there too.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gpt_sovits_tpu_torch import resolve_device
from gpt_sovits_tpu_torch.dsp.stft import istft_center, stft_center

# ---------------------------------------------------------------------------
# Band parameter tables (lib/lib_v5/modelparams/4band_v2.json, 4band_v3.json)
# ---------------------------------------------------------------------------

_BANDS_V2 = {
    1: dict(sr=7350, hl=80, n_fft=640, crop_start=0, crop_stop=85, lpf_start=25, lpf_stop=53),
    2: dict(sr=7350, hl=80, n_fft=320, crop_start=4, crop_stop=87, hpf_start=25, hpf_stop=12, lpf_start=31, lpf_stop=62),
    3: dict(sr=14700, hl=160, n_fft=512, crop_start=17, crop_stop=216, hpf_start=48, hpf_stop=24, lpf_start=139, lpf_stop=210),
    4: dict(sr=44100, hl=480, n_fft=960, crop_start=78, crop_stop=383, hpf_start=130, hpf_stop=86),
}

MODEL_PARAMS_4BAND_V2 = dict(bins=672, sr=44100, pre_filter_start=668, pre_filter_stop=672, band=_BANDS_V2)
MODEL_PARAMS_4BAND_V3 = dict(bins=672, sr=44100, pre_filter_start=668, pre_filter_stop=672, band=_BANDS_V2)


# ---------------------------------------------------------------------------
# Layers (layers_123821KB.py for the HP family, layers_new.py for the new nets)
# ---------------------------------------------------------------------------


class Conv2DBNActiv(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1, activ=nn.ReLU):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, ksize, stride, pad, dilation, bias=False), nn.BatchNorm2d(nout), activ())

    def forward(self, x):
        return self.conv(x)


class SeperableConv2DBNActiv(nn.Module):  # the reference's spelling
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1, activ=nn.ReLU):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nin, ksize, stride, pad, dilation, groups=nin, bias=False),
            nn.Conv2d(nin, nout, 1, bias=False), nn.BatchNorm2d(nout), activ())

    def forward(self, x):
        return self.conv(x)


def crop_center(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """h1 cut to h2's width (frames), centred (spec_utils.crop_center)."""
    if h1.shape[3] == h2.shape[3]:
        return h1
    if h1.shape[3] < h2.shape[3]:
        raise ValueError("h1 is narrower than h2")
    s = (h1.shape[3] - h2.shape[3]) // 2
    return h1[:, :, :, s: s + h2.shape[3]]


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class EncoderV2(nn.Module):
    """layers_123821KB.Encoder: conv1 at stride 1 is the skip, conv2 strides."""

    def __init__(self, nin, nout, ksize=3, stride=1, pad=1):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, 1, pad, activ=nn.LeakyReLU)
        self.conv2 = Conv2DBNActiv(nout, nout, ksize, stride, pad, activ=nn.LeakyReLU)

    def forward(self, x):
        skip = self.conv1(x)
        return self.conv2(skip), skip


class DecoderV2(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1):
        super().__init__()
        self.conv = Conv2DBNActiv(nin, nout, ksize, 1, pad)

    def forward(self, x, skip=None):
        x = _up2(x)
        if skip is not None:
            x = torch.cat([x, crop_center(skip, x)], dim=1)
        return self.conv(x)


class ASPPModuleV2(nn.Module):
    def __init__(self, nin, nout, dilations=(4, 8, 16)):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)), Conv2DBNActiv(nin, nin, 1, 1, 0))
        self.conv2 = Conv2DBNActiv(nin, nin, 1, 1, 0)
        self.conv3 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[0], dilations[0])
        self.conv4 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[1], dilations[1])
        self.conv5 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[2], dilations[2])
        self.bottleneck = nn.Sequential(Conv2DBNActiv(nin * 5, nout, 1, 1, 0), nn.Dropout2d(0.1))

    def forward(self, x):
        h, w = x.shape[2:]
        feat1 = F.interpolate(self.conv1(x), size=(h, w), mode="bilinear", align_corners=True)
        out = torch.cat([feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)], dim=1)
        return self.bottleneck(out)


class BaseASPPNet(nn.Module):
    def __init__(self, nin, ch, dilations=(4, 8, 16)):
        super().__init__()
        self.enc1 = EncoderV2(nin, ch, 3, 2, 1)
        self.enc2 = EncoderV2(ch, ch * 2, 3, 2, 1)
        self.enc3 = EncoderV2(ch * 2, ch * 4, 3, 2, 1)
        self.enc4 = EncoderV2(ch * 4, ch * 8, 3, 2, 1)
        self.aspp = ASPPModuleV2(ch * 8, ch * 16, dilations)
        self.dec4 = DecoderV2(ch * (8 + 16), ch * 8, 3, 1, 1)
        self.dec3 = DecoderV2(ch * (4 + 8), ch * 4, 3, 1, 1)
        self.dec2 = DecoderV2(ch * (2 + 4), ch * 2, 3, 1, 1)
        self.dec1 = DecoderV2(ch * (1 + 2), ch, 3, 1, 1)

    def forward(self, x):
        h, e1 = self.enc1(x)
        h, e2 = self.enc2(h)
        h, e3 = self.enc3(h)
        h, e4 = self.enc4(h)
        h = self.aspp(h)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        return self.dec1(h, e1)


def _apply_aggressiveness(mask: torch.Tensor, aggressiveness) -> torch.Tensor:
    if aggressiveness is None:
        return mask
    split, value = aggressiveness
    return torch.cat([mask[:, :, :split] ** (1 + value / 3), mask[:, :, split:] ** (1 + value)], dim=2)


class CascadedASPPNet(nn.Module):
    """nets_61968KB.CascadedASPPNet (ch 32; other HP widths by `ch`)."""

    def __init__(self, n_fft: int, ch: int = 32):
        super().__init__()
        self.stg1_low_band_net = BaseASPPNet(2, ch)
        self.stg1_high_band_net = BaseASPPNet(2, ch)
        self.stg2_bridge = Conv2DBNActiv(ch + 2, ch // 2, 1, 1, 0)
        self.stg2_full_band_net = BaseASPPNet(ch // 2, ch)
        self.stg3_bridge = Conv2DBNActiv(2 * ch + 2, ch, 1, 1, 0)
        self.stg3_full_band_net = BaseASPPNet(ch, 2 * ch)
        self.out = nn.Conv2d(2 * ch, 2, 1, bias=False)
        self.aux1_out = nn.Conv2d(ch, 2, 1, bias=False)  # training heads, unused here
        self.aux2_out = nn.Conv2d(ch, 2, 1, bias=False)
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.offset = 128

    def forward(self, x_mag: torch.Tensor, aggressiveness=None) -> torch.Tensor:
        """(B, 2, bins+1, T) magnitude -> masked magnitude, same shape."""
        mix = x_mag
        x = x_mag[:, :, : self.max_bin]
        bandw = x.shape[2] // 2
        aux1 = torch.cat([self.stg1_low_band_net(x[:, :, :bandw]), self.stg1_high_band_net(x[:, :, bandw:])], dim=2)
        aux2 = self.stg2_full_band_net(self.stg2_bridge(torch.cat([x, aux1], dim=1)))
        h = self.stg3_full_band_net(self.stg3_bridge(torch.cat([x, aux1, aux2], dim=1)))
        mask = torch.sigmoid(self.out(h))
        mask = F.pad(mask, (0, 0, 0, self.output_bin - mask.shape[2]), mode="replicate")
        return _apply_aggressiveness(mask, aggressiveness) * mix


class Encoder(nn.Module):
    """layers_new.Encoder: conv1 strides, conv2 keeps the size."""

    def __init__(self, nin, nout, ksize=3, stride=1, pad=1):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, stride, pad, activ=nn.LeakyReLU)
        self.conv2 = Conv2DBNActiv(nout, nout, ksize, 1, pad, activ=nn.LeakyReLU)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Decoder(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, 1, pad)

    def forward(self, x, skip=None):
        x = _up2(x)
        if skip is not None:
            x = torch.cat([x, crop_center(skip, x)], dim=1)
        return self.conv1(x)


class ASPPModule(nn.Module):
    def __init__(self, nin, nout, dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)), Conv2DBNActiv(nin, nout, 1, 1, 0))
        self.conv2 = Conv2DBNActiv(nin, nout, 1, 1, 0)
        self.conv3 = Conv2DBNActiv(nin, nout, 3, 1, dilations[0], dilations[0])
        self.conv4 = Conv2DBNActiv(nin, nout, 3, 1, dilations[1], dilations[1])
        self.conv5 = Conv2DBNActiv(nin, nout, 3, 1, dilations[2], dilations[2])
        self.bottleneck = Conv2DBNActiv(nout * 5, nout, 1, 1, 0)
        self.dropout = nn.Dropout2d(0.1)

    def forward(self, x):
        h, w = x.shape[2:]
        feat1 = F.interpolate(self.conv1(x), size=(h, w), mode="bilinear", align_corners=True)
        out = torch.cat([feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)], dim=1)
        return self.dropout(self.bottleneck(out))


class LSTMModule(nn.Module):
    """A 1-channel conv, a BiLSTM over frames, dense + BatchNorm1d + ReLU."""

    def __init__(self, nin_conv, nin_lstm, nout_lstm):
        super().__init__()
        self.conv = Conv2DBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = nn.LSTM(input_size=nin_lstm, hidden_size=nout_lstm // 2, bidirectional=True)
        self.dense = nn.Sequential(nn.Linear(nout_lstm, nin_lstm), nn.BatchNorm1d(nin_lstm), nn.ReLU())

    def forward(self, x):
        n, _, nbins, nframes = x.shape
        h = self.conv(x)[:, 0].permute(2, 0, 1)  # (nframes, N, nbins)
        h, _ = self.lstm(h)
        h = self.dense(h.reshape(-1, h.shape[-1]))
        return h.reshape(nframes, n, 1, nbins).permute(1, 2, 3, 0)


class BaseNet(nn.Module):
    def __init__(self, nin, nout, nin_lstm, nout_lstm, dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.enc1 = Conv2DBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = Encoder(nout, nout * 2, 3, 2, 1)
        self.enc3 = Encoder(nout * 2, nout * 4, 3, 2, 1)
        self.enc4 = Encoder(nout * 4, nout * 6, 3, 2, 1)
        self.enc5 = Encoder(nout * 6, nout * 8, 3, 2, 1)
        self.aspp = ASPPModule(nout * 8, nout * 8, dilations)
        self.dec4 = Decoder(nout * (6 + 8), nout * 6, 3, 1, 1)
        self.dec3 = Decoder(nout * (4 + 6), nout * 4, 3, 1, 1)
        self.dec2 = Decoder(nout * (2 + 4), nout * 2, 3, 1, 1)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = Decoder(nout * (1 + 2) + 1, nout * 1, 3, 1, 1)

    def forward(self, x):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


class CascadedNet(nn.Module):
    """nets_new.CascadedNet (DeEcho nout 48, DeReverb 64; nout_lstm 128)."""

    def __init__(self, n_fft: int, nout: int = 32, nout_lstm: int = 128):
        super().__init__()
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.nin_lstm = self.max_bin // 2
        self.offset = 64
        self.stg1_low_band_net = nn.Sequential(BaseNet(2, nout // 2, self.nin_lstm // 2, nout_lstm),
                                               Conv2DBNActiv(nout // 2, nout // 4, 1, 1, 0))
        self.stg1_high_band_net = BaseNet(2, nout // 4, self.nin_lstm // 2, nout_lstm // 2)
        self.stg2_low_band_net = nn.Sequential(BaseNet(nout // 4 + 2, nout, self.nin_lstm // 2, nout_lstm),
                                               Conv2DBNActiv(nout, nout // 2, 1, 1, 0))
        self.stg2_high_band_net = BaseNet(nout // 4 + 2, nout // 2, self.nin_lstm // 2, nout_lstm // 2)
        self.stg3_full_band_net = BaseNet(3 * nout // 4 + 2, nout, self.nin_lstm, nout_lstm)
        self.out = nn.Conv2d(nout, 2, 1, bias=False)
        self.aux_out = nn.Conv2d(3 * nout // 4, 2, 1, bias=False)  # training head, unused here

    def forward(self, x_mag: torch.Tensor, aggressiveness=None) -> torch.Tensor:
        """(B, 2, bins+1, T) magnitude -> masked magnitude, same shape."""
        mix = x_mag
        x = x_mag[:, :, : self.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)
        f3 = self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1))
        mask = torch.sigmoid(self.out(f3))
        mask = F.pad(mask, (0, 0, 0, self.output_bin - mask.shape[2]), mode="replicate")
        return _apply_aggressiveness(mask, aggressiveness) * mix


# ---------------------------------------------------------------------------
# Spec pipeline (spec_utils.py), on the host
# ---------------------------------------------------------------------------


def _stft_np(wave_lr: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """(2, L) -> (2, F, T) complex64, centred."""
    return stft_center(torch.from_numpy(np.ascontiguousarray(wave_lr, np.float32)), n_fft, hop).numpy()


def _istft_np(spec: np.ndarray, hop: int) -> np.ndarray:
    n_fft = 2 * (spec.shape[-2] - 1)
    return istft_center(torch.from_numpy(np.ascontiguousarray(spec, np.complex64)), n_fft, hop).numpy()


def _resample(x: np.ndarray, orig: int, target: int) -> np.ndarray:
    from math import gcd

    from scipy.signal import resample_poly

    if orig == target:
        return x
    g = gcd(orig, target)
    return resample_poly(x, target // g, orig // g, axis=-1).astype(np.float32)


def combine_spectrograms(specs: dict, mp: dict) -> np.ndarray:
    """spec_utils.combine_spectrograms:85."""
    l = min(s.shape[2] for s in specs.values())
    out = np.zeros((2, mp["bins"] + 1, l), np.complex64)
    ofs = 0
    for d in range(1, len(mp["band"]) + 1):
        bp = mp["band"][d]
        h = bp["crop_stop"] - bp["crop_start"]
        out[:, ofs: ofs + h] = specs[d][:, bp["crop_start"]: bp["crop_stop"], :l]
        ofs += h
    if mp["pre_filter_start"] > 0:
        gp = 1.0
        for b in range(mp["pre_filter_start"] + 1, mp["pre_filter_stop"]):
            g = 10 ** (-(b - mp["pre_filter_start"]) * (3.5 - gp) / 20.0)
            gp = g
            out[:, b] *= g
    return out


def fft_lp_filter(spec, start, stop):
    g = 1.0
    for b in range(start, stop):
        g -= 1 / (stop - start)
        spec[:, b] *= g
    spec[:, stop:] *= 0
    return spec


def fft_hp_filter(spec, start, stop):
    g = 1.0
    for b in range(start, stop, -1):
        g -= 1 / (start - stop)
        spec[:, b] *= g
    spec[:, : stop + 1] *= 0
    return spec


def wave_to_combined_spec(wav44: np.ndarray, mp: dict) -> tuple[np.ndarray, np.ndarray, int]:
    """(2, L)@44100 -> (combined spec, high-end input spec, high-end h)."""
    bands_n = len(mp["band"])
    specs, waves = {}, {}
    input_high_end, input_high_end_h = None, 0
    for d in range(bands_n, 0, -1):
        bp = mp["band"][d]
        waves[d] = wav44 if d == bands_n else _resample(waves[d + 1], mp["band"][d + 1]["sr"], bp["sr"])
        specs[d] = _stft_np(waves[d], bp["n_fft"], bp["hl"])
        if d == bands_n:
            input_high_end_h = (bp["n_fft"] // 2 - bp["crop_stop"]) + (mp["pre_filter_stop"] - mp["pre_filter_start"])
            input_high_end = specs[d][:, bp["n_fft"] // 2 - input_high_end_h: bp["n_fft"] // 2, :]
    return combine_spectrograms(specs, mp), input_high_end, input_high_end_h


def mirroring(spec_m: np.ndarray, input_high_end: np.ndarray, mp: dict) -> np.ndarray:
    """spec_utils.mirroring:421 ('mirroring' mode)."""
    k = mp["pre_filter_start"] - 10
    mirror = np.flip(np.abs(spec_m[:, k - input_high_end.shape[1]: k, : input_high_end.shape[2]]), 1)
    mirror = mirror * np.exp(1.0j * np.angle(input_high_end))
    return np.where(np.abs(input_high_end) <= np.abs(mirror), input_high_end, mirror)


def combined_spec_to_wave(spec_m: np.ndarray, mp: dict, extra_h: int = 0, extra: np.ndarray | None = None) -> np.ndarray:
    """spec_utils.cmb_spectrogram_to_wave:327 -> (L, 2) float at mp['sr']."""
    bands_n = len(mp["band"])
    ofs = 0
    wave = None

    def add(a, b):  # guard against one-sample resampler drift
        n = min(a.shape[-1], b.shape[-1])
        return a[..., :n] + b[..., :n]

    for d in range(1, bands_n + 1):
        bp = mp["band"][d]
        spec_s = np.zeros((2, bp["n_fft"] // 2 + 1, spec_m.shape[2]), np.complex64)
        h = bp["crop_stop"] - bp["crop_start"]
        spec_s[:, bp["crop_start"]: bp["crop_stop"]] = spec_m[:, ofs: ofs + h]
        ofs += h
        if d == bands_n:
            if extra_h and extra is not None:
                max_bin = bp["n_fft"] // 2
                spec_s[:, max_bin - extra_h: max_bin] = extra[:, :extra_h, : spec_s.shape[2]]
            if bp.get("hpf_start", 0) > 0:
                spec_s = fft_hp_filter(spec_s, bp["hpf_start"], bp["hpf_stop"] - 1)
            wave = _istft_np(spec_s, bp["hl"]) if bands_n == 1 else add(wave, _istft_np(spec_s, bp["hl"]))
        elif d == 1:
            spec_s = fft_lp_filter(spec_s, bp["lpf_start"], bp["lpf_stop"])
            wave = _resample(_istft_np(spec_s, bp["hl"]), bp["sr"], mp["band"][2]["sr"])
        else:
            spec_s = fft_hp_filter(spec_s, bp["hpf_start"], bp["hpf_stop"] - 1)
            spec_s = fft_lp_filter(spec_s, bp["lpf_start"], bp["lpf_stop"])
            wave = _resample(add(wave, _istft_np(spec_s, bp["hl"])), bp["sr"], mp["band"][d + 1]["sr"])
    return wave.T


# ---------------------------------------------------------------------------
# Windowed inference (lib/utils.py:25) + loader + top-level separate()
# ---------------------------------------------------------------------------


def _make_padding(width, cropsize, offset):
    left = offset
    roi = cropsize - 2 * left
    if roi == 0:
        roi = cropsize
    right = roi - (width % roi) + left
    return left, right, roi


def run_masking(model_fn, X_spec: np.ndarray, *, offset: int, window_size: int = 512, tta: bool = False):
    """Windowed magnitude-mask inference. X_spec (2, bins+1, T) complex;
    model_fn: (1, 2, bins+1, window_size) float32 tensor -> same shape, one
    window at a time as the reference runs them (batched, a track's windows
    would take device memory in proportion to the track's length).

    Returns (pred magnitude, X_mag, X_phase as a unit complex)."""
    X_mag = np.abs(X_spec)
    X_phase = np.angle(X_spec)
    coef = X_mag.max()
    X_pre = X_mag / max(coef, 1e-9)

    def execute(pad_l, pad_r, roi, n_window):
        Xp = np.pad(X_pre, ((0, 0), (0, 0), (pad_l, pad_r)), mode="constant").astype(np.float32)
        preds = []
        for i in range(n_window):
            win = torch.from_numpy(np.ascontiguousarray(Xp[None, :, :, i * roi: i * roi + window_size]))
            with torch.no_grad():
                pred = model_fn(win).float().cpu().numpy()[0]
            preds.append(pred[:, :, offset: -offset if offset else None])
        return np.concatenate(preds, axis=2)

    n_frame = X_pre.shape[2]
    pad_l, pad_r, roi = _make_padding(n_frame, window_size, offset)
    n_window = int(np.ceil(n_frame / roi))
    pred = execute(pad_l, pad_r, roi, n_window)[:, :, :n_frame]
    if tta:
        pad_l += roi // 2
        pad_r += roi // 2
        pred_tta = execute(pad_l, pad_r, roi, n_window + 1)[:, :, roi // 2:][:, :, :n_frame]
        pred = (pred + pred_tta) * 0.5
    return pred * coef, X_mag, np.exp(1.0j * X_phase)


def load_vr_model(model_path: str, device=None):
    """-> (net in eval mode on `device`, band params, kind, offset). The
    family is told apart by its keys (the new nets have stg2_low_band_net);
    the widths are read from the weights."""
    from gpt_sovits_tpu_torch.train.ckpt import load_torch_checkpoint

    dev = resolve_device(device)
    sd = load_torch_checkpoint(model_path)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    is_new = any(k.startswith("stg2_low_band_net") for k in sd)
    mp = dict(MODEL_PARAMS_4BAND_V3 if is_new else MODEL_PARAMS_4BAND_V2)
    n_fft = mp["bins"] * 2
    if is_new:
        nout = sd["stg3_full_band_net.enc1.conv.0.weight"].shape[0]
        nout_lstm = 2 * sd["stg1_low_band_net.0.lstm_dec2.lstm.weight_hh_l0"].shape[1]
        net = CascadedNet(n_fft, nout, nout_lstm)
    else:
        net = CascadedASPPNet(n_fft, sd["stg1_low_band_net.enc1.conv1.conv.0.weight"].shape[0])
    net.load_state_dict(sd, strict=True)
    return net.to(dev).eval(), mp, "deecho" if is_new else "hp", net.offset


def separate(wav: np.ndarray, sr: int, model_path: str, *, agg: int = 10, tta: bool = False,
             device=None) -> tuple[np.ndarray, np.ndarray]:
    """(L,) or (S, L) input -> (vocals, accompaniment) at the input rate.

    HP-family nets predict the accompaniment magnitude (vocals are the
    residual, vr.py:106-107); DeEcho-family nets predict the vocal (the
    reference's outputs are name-swapped there, vr.py:219)."""
    from gpt_sovits_tpu_torch.dsp.audio_io import resample as rs

    net, mp, kind, offset = load_vr_model(model_path, device)
    dev = next(net.parameters()).device

    mono_in = wav.ndim == 1
    x = wav[None] if mono_in else np.asarray(wav, np.float32)
    if x.shape[0] == 1:
        x = np.repeat(x, 2, axis=0)
    if sr != mp["sr"]:
        x = np.stack([rs(c, sr, mp["sr"]) for c in x])

    X_spec, high_end, high_end_h = wave_to_combined_spec(x, mp)
    aggressiveness = (mp["band"][1]["crop_stop"], agg / 100.0)
    pred, X_mag, X_phase = run_masking(lambda w: net(w.to(dev), aggressiveness), X_spec, offset=offset, tta=tta)

    y_spec = pred * X_phase  # what the net isolates
    v_spec = X_spec - y_spec

    def to_wave(spec):
        extra = mirroring(spec, high_end, mp)
        return combined_spec_to_wave(spec, mp, high_end_h, extra).T  # (2, L)

    y_wav, v_wav = to_wave(y_spec), to_wave(v_spec)
    vocals, other = (y_wav, v_wav) if kind == "deecho" else (v_wav, y_wav)
    if sr != mp["sr"]:
        vocals = np.stack([rs(c, mp["sr"], sr) for c in vocals])
        other = np.stack([rs(c, mp["sr"], sr) for c in other])

    def fit(a, n):
        return a[..., :n] if a.shape[-1] >= n else np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])])

    n_in = wav.shape[-1]
    vocals, other = fit(vocals, n_in), fit(other, n_in)
    if mono_in:
        vocals, other = vocals.mean(axis=0), other.mean(axis=0)
    return vocals.astype(np.float32), other.astype(np.float32)
