"""The port's centred STFT/iSTFT (gpt_sovits_tpu_torch/dsp/stft.py) against
the JAX package's matmul-DFT version (gpt_sovits_tpu/dsp/stft.py) on the
same seeded input: the spectrum within 1e-5 of its peak, the inverse within
1e-5 absolute (f32 both; the JAX test of these functions holds them to
torch within 2e-3), including a window shorter than n_fft and a `length`
shorter and longer than the natural one (the tail beyond it is zeros)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.dsp import stft as jstft
from gpt_sovits_tpu_torch.dsp import stft as pstft

CASES = [(512, 160, None), (512, 128, 400), (128, 32, None), (2048, 441, 2048)]


@pytest.mark.parametrize("n_fft,hop,win", CASES)
@pytest.mark.parametrize("length", [None, 3990, 4100])
def test_stft_istft_equal_jax(n_fft, hop, win, length):
    x = np.random.default_rng(n_fft + hop).standard_normal((2, 3, 4000)).astype(np.float32)
    zj = np.asarray(jstft.stft_center(jnp.asarray(x), n_fft, hop, win))
    zp = pstft.stft_center(torch.from_numpy(x), n_fft, hop, win)
    assert zp.dtype == torch.complex64 and zp.shape == zj.shape
    assert np.abs(zp.numpy() - zj).max() <= 1e-5 * np.abs(zj).max()
    yj = np.asarray(jstft.istft_center(jnp.asarray(zj), n_fft, hop, win, length=length))
    yp = pstft.istft_center(zp, n_fft, hop, win, length=length).numpy()
    assert yp.shape == yj.shape
    np.testing.assert_allclose(yp, yj, atol=1e-5)
    natural = hop * (zp.shape[-1] - 1)
    core = slice(n_fft // 2, min(natural, yp.shape[-1]) - n_fft // 2)
    np.testing.assert_allclose(yp[..., core], x[..., core], atol=1e-5)  # a round trip away from the edges


def test_istft_zero_pads_beyond_the_natural_length():
    x = np.random.default_rng(0).standard_normal((1, 1000)).astype(np.float32)
    z = pstft.stft_center(torch.from_numpy(x), 128, 32)
    natural = pstft.istft_center(z, 128, 32).shape[-1]
    y = pstft.istft_center(z, 128, 32, length=natural + 50).numpy()
    assert natural == 992 and np.all(y[:, natural:] == 0.0)
