"""Host-side audio I/O (a numpy copy of gpt_sovits_tpu/dsp/audio_io.py).

Replaces the reference's ffmpeg-subprocess loader (tools/my_utils.py:16
`load_audio`) with a pure-python RIFF/WAV parser (PCM 16/24/32 and IEEE
float32) plus an ffmpeg fallback for compressed formats when the binary is
present. Resampling is polyphase (scipy), matching librosa.resample's
soxr-quality closely enough for feature extraction.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess

import numpy as np
from scipy import signal as _signal


def _parse_wav(data: bytes) -> tuple[np.ndarray, int]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, n_ch, sr, _, _, bits = fmt
    if audio_fmt == 0xFFFE and len(data) >= 2:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = 1 if bits in (16, 24, 32) else 3
    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:  # IEEE float
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {audio_fmt}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch)
    return x, sr


def _ffmpeg_load(path: str, sr: int | None) -> tuple[np.ndarray, int]:
    """ffmpeg f32le pipe, mirroring tools/my_utils.py:16-35."""
    out_sr = sr or 32000
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", path,
        "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1", "-ar", str(out_sr), "-",
    ]
    proc = subprocess.run(cmd, capture_output=True, check=True)
    return np.frombuffer(proc.stdout, dtype=np.float32).copy(), out_sr


def load_wav(path: str, sr: int | None = None) -> tuple[np.ndarray, int]:
    """Load audio as mono float32 in [-1, 1]; optionally resample to `sr`."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        with open(path, "rb") as f:
            x, file_sr = _parse_wav(f.read())
        if x.ndim == 2:
            x = x.mean(axis=1)
    elif shutil.which("ffmpeg"):
        return _ffmpeg_load(path, sr)
    else:
        raise ValueError(f"cannot load {ext} without ffmpeg; provide a .wav")
    if sr is not None and sr != file_sr:
        x = resample(x, file_sr, sr)
        file_sr = sr
    return x, file_sr


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (host-side, numpy)."""
    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    g = np.gcd(int(orig_sr), int(target_sr))
    out = _signal.resample_poly(np.asarray(x, dtype=np.float64), target_sr // g, orig_sr // g)
    return out.astype(np.float32)
