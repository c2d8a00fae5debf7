"""Centred complex STFT / iSTFT (port of gpt_sovits_tpu/dsp/stft.py).

The corpus tools (UVR5 separation: the RoFormers, the VR band pipeline,
MDX-Net) use torch.stft/istft's centred framing: reflect-pad n_fft//2 on
each side, a periodic Hann window of `win_size` centred in n_fft, and the
inverse by window-square overlap-add. Here both directions are torch's own
FFT calls, on whatever device the input lies.
"""

from __future__ import annotations

import torch


def _window(n_fft: int, win_size: int, device) -> torch.Tensor:
    """Periodic Hann of win_size, zero-padded to n_fft and centred in it."""
    win = torch.hann_window(win_size, periodic=True, dtype=torch.float32, device=device)
    if win_size < n_fft:
        ofs = (n_fft - win_size) // 2
        win = torch.nn.functional.pad(win, (ofs, n_fft - win_size - ofs))
    return win


def stft_center(y: torch.Tensor, n_fft: int, hop: int, win_size: int | None = None) -> torch.Tensor:
    """(..., L) real -> (..., n_fft//2+1, T) complex64; torch.stft(center=True)."""
    win_size = win_size or n_fft
    shape = y.shape
    z = torch.stft(y.reshape(-1, shape[-1]).float(), n_fft, hop_length=hop, window=_window(n_fft, win_size, y.device),
                   center=True, pad_mode="reflect", return_complex=True)
    return z.reshape(*shape[:-1], z.shape[-2], z.shape[-1])


def istft_center(z: torch.Tensor, n_fft: int, hop: int, win_size: int | None = None,
                 length: int | None = None) -> torch.Tensor:
    """(..., n_fft//2+1, T) complex -> (..., L) real; torch.istft(center=True):
    window-square normalised overlap-add, the n_fft//2 centre padding trimmed,
    then cut or zero-padded to `length` when given. (torch.istft's own
    `length` would fill a longer output from the overlap-add of the trimmed
    right padding instead of zeros: the length is applied here.)"""
    win_size = win_size or n_fft
    shape = z.shape
    out = torch.istft(z.reshape(-1, shape[-2], shape[-1]).to(torch.complex64), n_fft, hop_length=hop,
                      window=_window(n_fft, win_size, z.device), center=True)
    if length is not None:
        out = out[:, :length] if length <= out.shape[-1] else torch.nn.functional.pad(out, (0, length - out.shape[-1]))
    return out.reshape(*shape[:-2], out.shape[-1])
