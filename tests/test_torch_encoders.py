"""Reference-side encoders of the port (CNHuBERT, ERes2NetV2, kaldi fbank,
linear spectrogram) against the JAX package on the CPU, same weights and
numpy-made waveforms, f32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.dsp import mel as jmel
from gpt_sovits_tpu.models import eres2net as jer
from gpt_sovits_tpu.models import hubert as jhub
from gpt_sovits_tpu.utils.config import MelConfig as JMelConfig
from gpt_sovits_tpu_torch.dsp.mel import spectrogram
from gpt_sovits_tpu_torch.models import eres2net as per
from gpt_sovits_tpu_torch.models import hubert as phub
from gpt_sovits_tpu_torch.utils.config import MelConfig
from gpt_sovits_tpu_torch.weights import eres2net_from_jax, hubert_from_jax

torch.set_num_threads(1)

HUBERT_TINY = dict(
    conv_dim=32, conv_kernels=(10, 3, 2), conv_strides=(5, 2, 2), hidden_size=48, num_layers=2,
    num_heads=4, intermediate_size=64, pos_conv_kernel=16, pos_conv_groups=4,
)
SV_TINY = dict(num_blocks=(1, 1, 2, 1), m_channels=8, feat_dim=32, base_width=24, scale=4, expansion=4)


def random_params(model, *args, seed=0, **kw):
    """Parameters of the flax model's shapes drawn with numpy (no per-leaf
    init compiles): scales near 1, variances positive, the rest N(0, 0.2)."""
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(0),
                                                "slice": jax.random.PRNGKey(0)}, *args, **kw))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1])
        if "var" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "scale" in name or "alpha" in name:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _wav(n, seed=0, amp=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (amp * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)[None]


def test_hubert_allclose():
    """12 post-LN layers at full size, 2 here; f32 sums in other orders: 1e-4."""
    jm = jhub.HubertEncoder(jhub.HubertConfig(**HUBERT_TINY))
    wav = _wav(3200)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 800)))
    pm = phub.HubertEncoder(phub.HubertConfig(**HUBERT_TINY))
    pm.load_state_dict(hubert_from_jax(jax.tree.map(np.asarray, params), pm.cfg), strict=True)
    yj = np.asarray(jm.apply(params, jnp.asarray(wav)))
    with torch.no_grad():
        yp = pm(torch.from_numpy(wav)).numpy()
    assert yp.shape == yj.shape
    np.testing.assert_allclose(yp, yj, atol=1e-4, rtol=1e-4)


def test_eres2netv2_allclose():
    """Random weights and BatchNorm statistics; 1e-4 relative
    to the embedding's scale (f32, deep conv stack)."""
    cfg_j = jer.ERes2NetConfig(**SV_TINY)
    jm = jer.ERes2NetV2(cfg_j)
    params = random_params(jm, jnp.zeros((1, 24, SV_TINY["feat_dim"])))
    rng = np.random.default_rng(1)
    pm = per.ERes2NetV2(per.ERes2NetConfig(**SV_TINY))
    pm.load_state_dict(eres2net_from_jax(params, pm.cfg), strict=True)
    feat = rng.standard_normal((2, 40, SV_TINY["feat_dim"])).astype(np.float32)
    yj = np.asarray(jm.apply(params, jnp.asarray(feat)))
    with torch.no_grad():
        yp = pm(torch.from_numpy(feat)).numpy()
    assert yp.shape == yj.shape
    np.testing.assert_allclose(yp, yj, atol=1e-4 * np.abs(yj).max(), rtol=1e-4)


def test_kaldi_fbank_allclose():
    """rfft on both sides in f32; log-mel agrees to 1e-4 absolute (log of
    power sums, frames of 400 samples)."""
    wav = _wav(16000, seed=2)
    fj = np.asarray(jer.kaldi_fbank(jnp.asarray(wav)))
    fp = per.kaldi_fbank(torch.from_numpy(wav)).numpy()
    assert fp.shape == fj.shape
    np.testing.assert_allclose(fp, fj, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("n_fft,hop", [(2048, 640), (128, 64)])
def test_spectrogram_allclose(n_fft, hop):
    """torch.stft vs the JAX matmul DFT: f32 sums over n_fft samples."""
    cfg = dict(sampling_rate=32000, n_fft=n_fft, win_size=n_fft, hop_size=hop, num_mels=13)
    wav = _wav(12000, seed=3)
    sj = np.asarray(jmel.spectrogram(jnp.asarray(wav), JMelConfig(**cfg)))
    sp = spectrogram(torch.from_numpy(wav), MelConfig(**cfg)).numpy()
    assert sp.shape == sj.shape
    np.testing.assert_allclose(sp, sj, atol=2e-4 * np.abs(sj).max(), rtol=1e-3)
