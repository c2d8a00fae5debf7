"""The port's UVR5 VR separators (gpt_sovits_tpu_torch/corpus/vr.py) against
the JAX package's (gpt_sovits_tpu/corpus/vr.py) on the CPU. The port's nets
carry the reference's state-dict names with BatchNorm unfolded; their
weights, BatchNorm statistics randomised, go into JAX through its own
`fold_params`. Both families within 1e-5 of JAX (the JAX test holds JAX to
the reference within 2e-4), with and without the aggressiveness powers; the
host band pipeline and the windowed masking equal JAX's; `separate` on a
`.pth` file of each family within 1e-5."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.corpus import vr as jv
from gpt_sovits_tpu_torch.corpus import vr as pv

TOL = 1e-5


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def randomize_bn(model, seed: int):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d)):
                m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=g) * 0.4 - 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.rand(m.bias.shape, generator=g) * 0.4 - 0.2)
    return model.eval()


def hp_net(n_fft=64, ch=32, seed=0):
    torch.manual_seed(seed)
    return randomize_bn(pv.CascadedASPPNet(n_fft, ch), seed)


def deecho_net(n_fft=128, nout=32, nout_lstm=64, seed=1):
    torch.manual_seed(seed)
    return randomize_bn(pv.CascadedNet(n_fft, nout, nout_lstm), seed)


@pytest.mark.parametrize("agg", [None, (10, 0.1)])
def test_cascaded_aspp_net_equals_jax(agg):
    net = hp_net()
    x = np.abs(np.random.default_rng(0).standard_normal((1, 2, 33, 32))).astype(np.float32)
    fn = jax.jit(lambda p, w: jv.cascaded_aspp_net(p, w, 64, agg))  # jitted: ~8x faster than eager here
    want = np.asarray(fn(jv.fold_params(net.state_dict()), jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), agg).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("agg", [None, (20, 0.3)])
def test_cascaded_net_equals_jax(agg):
    net = deecho_net()
    x = np.abs(np.random.default_rng(1).standard_normal((1, 2, 65, 32))).astype(np.float32)
    fn = jax.jit(lambda p, w: jv.cascaded_net(p, w, 128, agg))
    want = np.asarray(fn(jv.fold_params(net.state_dict()), jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), agg).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_band_pipeline_equals_jax():
    rng = np.random.default_rng(2)
    t = np.arange(44100) / 44100
    wav = np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 550 * t)]).astype(np.float32)
    wav += 0.01 * rng.standard_normal(wav.shape).astype(np.float32)
    mp = pv.MODEL_PARAMS_4BAND_V2
    spec, he, he_h = pv.wave_to_combined_spec(wav, mp)
    jspec, jhe, jhe_h = jv.wave_to_combined_spec(wav, jv.MODEL_PARAMS_4BAND_V2)
    assert spec.shape == jspec.shape == (2, 673, spec.shape[2]) and he_h == jhe_h
    np.testing.assert_allclose(spec, jspec, atol=1e-3)  # |X| up to ~480: 2e-6 relative
    np.testing.assert_allclose(he, jhe, atol=1e-3)
    extra = pv.mirroring(spec, he, mp)
    np.testing.assert_allclose(extra, jv.mirroring(jspec, jhe, mp), atol=1e-3)
    out = pv.combined_spec_to_wave(spec, mp, he_h, extra)
    np.testing.assert_allclose(out, jv.combined_spec_to_wave(jspec, mp, jhe_h, extra), atol=TOL)


@pytest.mark.parametrize("tta", [False, True])
def test_run_masking_equals_jax(tta):
    net = hp_net(n_fft=64, ch=8, seed=3)
    p = jv.fold_params(net.state_dict())
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((2, 33, 300)) + 1j * rng.standard_normal((2, 33, 300))).astype(np.complex64)
    fn = jax.jit(lambda pp, w: jv.cascaded_aspp_net(pp, w, 64))
    want = jv.run_masking(lambda w: fn(p, w), X, offset=16, window_size=128, tta=tta)
    got = pv.run_masking(lambda w: net(w), X, offset=16, window_size=128, tta=tta)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL * 4)  # pred * coef, |X| up to ~4


@pytest.mark.parametrize("family", ["hp", "deecho"])
def test_separate_on_a_pth_file_equals_jax(family, tmp_path):
    net = hp_net(1344, ch=4, seed=4) if family == "hp" else deecho_net(1344, nout=8, nout_lstm=16, seed=5)
    path = tmp_path / f"{family}.pth"
    torch.save(net.state_dict(), path)
    t = np.arange(int(0.6 * 32000)) / 32000
    wav = np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)]).astype(np.float32) * 0.3
    vj, oj = jv.separate(wav, 32000, str(path), agg=10)
    vp, op = pv.separate(wav, 32000, str(path), agg=10, device="cpu")
    assert vp.shape == vj.shape == wav.shape and op.shape == oj.shape
    np.testing.assert_allclose(vp, vj, atol=TOL)
    np.testing.assert_allclose(op, oj, atol=TOL)
    loaded, mp, kind, offset = pv.load_vr_model(str(path), device="cpu")
    assert (kind, offset) == (("hp", 128) if family == "hp" else ("deecho", 64))
    assert type(loaded) is type(net) and mp["bins"] == 672
