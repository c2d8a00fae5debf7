"""The port's MDX-Net separator (gpt_sovits_tpu_torch/corpus/mdx.py) on its
ONNX executor against the JAX package's (gpt_sovits_tpu/corpus/mdx.py) on
its own, same graph file: the ConvTDF framing (within 1e-4 of the spectrum's
peak; the JAX test holds JAX to torch.stft within 2e-3) and `separate`
through a seeded Conv/BatchNorm/ReLU graph (chip_smoke.write_mdx_onnx, the
graph the card's phase runs) and through an identity graph, within 1e-5 of
the mix's scale; the margin-chunked demix over several segments."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gpt_sovits_tpu.corpus import mdx as jm
from gpt_sovits_tpu_torch.corpus import mdx as pm

CFG = dict(dim_t_log2=5, dim_f=65, n_fft=128, hop=64, chunks=1, margin=8000, sr=8000, denoise=True)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("dim_f", [65, 48])
def test_framing_equals_jax(dim_f):
    cfg = dict(CFG, dim_f=dim_f)
    pc, jc = pm.MDXConfig(**cfg), jm.MDXConfig(**cfg)
    x = np.random.default_rng(0).standard_normal((2, 2, pc.chunk_size)).astype(np.float32)
    spek = pm.spec_of(torch.from_numpy(x), pc).numpy()
    want = np.asarray(jm.spec_of(jnp.asarray(x), jc))
    assert spek.shape == want.shape == (2, 4, dim_f, pc.dim_t)
    assert np.abs(spek - want).max() <= 1e-4 * np.abs(want).max()
    back = pm.wave_of(torch.from_numpy(spek), pc).numpy()
    np.testing.assert_allclose(back, np.asarray(jm.wave_of(jnp.asarray(want), jc)), atol=1e-4)


@pytest.mark.parametrize("graph", ["seeded", "identity"])
@pytest.mark.parametrize("denoise", [True, False])
def test_separate_equals_jax(graph, denoise, tmp_path):
    cfg = dict(CFG, denoise=denoise)
    path = str(tmp_path / "vocals.onnx")
    chip_smoke.write_mdx_onnx(path, seed=1, width=8 if graph == "seeded" else 0)
    rng = np.random.default_rng(1)
    mix = (0.3 * rng.standard_normal((2, 2 * 8000 + 321))).astype(np.float32)
    for sr in (8000, 16000):
        mj, oj = jm.separate(mix, sr, path, cfg=jm.MDXConfig(**cfg))
        mp, op = pm.separate(mix, sr, path, cfg=pm.MDXConfig(**cfg), device="cpu")
        assert mp.shape == mj.shape == mix.shape and op.shape == oj.shape
        scale = max(np.abs(oj).max(), np.abs(mix).max())
        np.testing.assert_allclose(mp, mj, atol=TOL * scale)
        np.testing.assert_allclose(op, oj, atol=TOL * scale)
    if graph == "identity":  # the stem is the mix, the main part silence (away from the STFT edges)
        core = slice(64, -64)
        mp, op = pm.separate(mix[0], 8000, path, cfg=pm.MDXConfig(**cfg), device="cpu")
        np.testing.assert_allclose(op[core], mix[0][core], atol=5e-3)
        assert np.abs(mp[core]).max() < 5e-3


def test_demix_multi_segment(tmp_path):
    path = str(tmp_path / "vocals.onnx")
    chip_smoke.write_mdx_onnx(path, seed=2, width=0)
    mix = (0.2 * np.random.default_rng(2).standard_normal((2, 3 * 8000 + 123))).astype(np.float32)
    out = pm.MDXSeparator(path, pm.MDXConfig(**CFG), device="cpu").demix(mix)
    assert out.shape == mix.shape
    np.testing.assert_allclose(out[:, 64:-64], mix[:, 64:-64], atol=5e-3)
