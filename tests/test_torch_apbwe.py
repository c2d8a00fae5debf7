"""The port's AP-BWE (gpt_sovits_tpu_torch/models/apbwe.py) against the JAX
package's (gpt_sovits_tpu/models/apbwe.py) on the CPU, same weights (numpy,
seeded) and audio, in f32:

  * `amp_pha_stft` (torch.stft) against the JAX framing + rfft: log
    amplitude within 1e-4, phase within 1e-3 rad wherever the bin's
    amplitude is above 1e-3 (below it the angle is noise);
  * `amp_pha_istft` (torch.istft) against the JAX overlap-add: 1e-5;
  * a tiny `APNetBWE` (32 channels, 2 layers, n_fft 64, hop 16) against
    `APNetBWE.apply`: amplitude within 1e-4 x its scale, phase (atan2)
    within 1e-3 rad modulo 2 pi;
  * `super_resolve` end to end (host resampling, STFT, model, iSTFT):
    waveforms within 1e-4 x their scale, the same length (the phase
    stream's input convolution zeroed: see the test);
  * `apbwe_from_jax` names: read back by the JAX package's
    `params_from_torch` (models/apbwe.py:134), tensor for tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.models import apbwe as japbwe
from gpt_sovits_tpu_torch.models.apbwe import APBWEConfig, APNetBWE, amp_pha_istft, amp_pha_stft, super_resolve
from gpt_sovits_tpu_torch.weights import apbwe_from_jax

torch.set_num_threads(1)
CFG = dict(n_fft=64, hop_size=16, win_size=64, channels=32, layers=2, hr_sampling_rate=16000)
STFT = (64, 16, 64)


def _audio(seed, n=1000, b=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000.0
    return (0.3 * np.sin(2 * np.pi * 440 * t)[None] + 0.05 * rng.standard_normal((b, n))).astype(np.float32)


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b, np.float64)))))


@pytest.fixture(scope="module")
def models():
    jm = japbwe.APNetBWE(japbwe.APBWEConfig(**CFG))
    bins = CFG["n_fft"] // 2 + 1
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, bins, 8)), jnp.zeros((1, bins, 8))))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    pm = APNetBWE(APBWEConfig(**CFG)).eval()
    pm.load_state_dict(apbwe_from_jax(params, pm.cfg), strict=True)
    return jm, params, pm


def test_stft_matches_jax():
    x = _audio(1)
    la_j, ph_j = (np.asarray(a) for a in japbwe.amp_pha_stft(jnp.asarray(x), *STFT))
    la_p, ph_p = (a.numpy() for a in amp_pha_stft(torch.from_numpy(x), *STFT))
    assert la_p.shape == la_j.shape == (2, 33, 1 + 1000 // 16)
    np.testing.assert_allclose(la_p, la_j, rtol=0, atol=1e-4)
    live = np.exp(la_j) > 1e-3
    assert live.mean() > 0.9 and _wrapped(ph_p, ph_j)[live].max() < 1e-3


def test_istft_matches_jax():
    rng = np.random.default_rng(2)
    la = (rng.standard_normal((2, 33, 40)) * 0.5 - 1.0).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (2, 33, 40)).astype(np.float32)
    want = np.asarray(japbwe.amp_pha_istft(jnp.asarray(la), jnp.asarray(ph), *STFT))
    got = amp_pha_istft(torch.from_numpy(la), torch.from_numpy(ph), *STFT).numpy()
    assert got.shape == want.shape == (2, 16 * 39)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_apnet_bwe_matches_jax(models):
    jm, params, pm = models
    la, ph = amp_pha_stft(torch.from_numpy(_audio(3)), *STFT)
    mag_j, pha_j = (np.asarray(a) for a in jm.apply(params, jnp.asarray(la.numpy()), jnp.asarray(ph.numpy())))
    with torch.no_grad():
        mag_p, pha_p = (a.numpy() for a in pm(la, ph))
    assert mag_p.shape == mag_j.shape == pha_p.shape == la.shape
    np.testing.assert_allclose(mag_p, mag_j, rtol=0, atol=1e-4 * np.abs(mag_j).max())
    assert _wrapped(pha_p, pha_j).max() < 1e-3


def test_super_resolve_matches_jax(models):
    """The x2 resampled input has an empty upper band, whose STFT phases are
    round-off noise that differs between the two FFTs; the phase stream's
    input convolution is zeroed on both sides so that the noise does not
    enter, and the rest of the chain is held."""
    jm, params, pm = models
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.zeros_like(a) if "conv_pre_pha" in str(path) and "kernel" in str(path) else a, params)
    pm = APNetBWE(APBWEConfig(**CFG)).eval()
    pm.load_state_dict(apbwe_from_jax(params, pm.cfg), strict=True)
    x = _audio(4, n=1200)
    want, sr_j = japbwe.super_resolve(jm, params, jnp.asarray(x), 8000)
    got, sr_p = super_resolve(pm, x, 8000)
    want = np.asarray(want)
    assert sr_p == sr_j == 16000 and got.shape == want.shape == (2, 16 * (2400 // 16))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_apbwe_from_jax_names_read_back(models):
    _, params, pm = models
    sd = apbwe_from_jax(params, pm.cfg)
    assert set(sd) == set(pm.state_dict())
    back = japbwe.params_from_torch(sd, japbwe.APBWEConfig(**CFG))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(flat_back) == set(flat) and len(flat) == len(sd)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))
