"""The v4 path's modules in the port against the JAX package at tiny sizes,
same weights (numpy, seeded) and inputs, f32 on both sides:
`SynthesizerTrnV3.decode_encp`, `cfm_inference` fed the same noise, the mel
front end, the v4 vocoder (`Generator` with a post bias, without `cond`),
`sola_stitch`, `_mel_len_for` and the chunk assembly of the batched branch."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.dsp import mel as jmel
from gpt_sovits_tpu.dsp.sola import sola_stitch as j_sola
from gpt_sovits_tpu.infer import pipeline as jpipe
from gpt_sovits_tpu.models.dit import DiT as JDiT
from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3 as JV3
from gpt_sovits_tpu.models.v3 import cfm_inference as j_cfm
from gpt_sovits_tpu.models.vits import Generator as JGen
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch.dsp import mel as pmel
from gpt_sovits_tpu_torch.dsp.sola import sola_stitch
from gpt_sovits_tpu_torch.infer import pipeline as ppipe
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3, cfm_inference
from gpt_sovits_tpu_torch.models.vits import Generator
from gpt_sovits_tpu_torch.utils import config as pconfig
from gpt_sovits_tpu_torch.weights import s2v3_from_jax, vocoder_v4_from_jax

torch.set_num_threads(1)

V4 = dict(version="v4", spec_channels=65, inter_channels=32, hidden_channels=32, filter_channels=48, n_heads=2,
          n_layers=4, kernel_size=3, gin_channels=32, mrte_hidden=32, ssl_dim=48, n_codes=32,
          cfm_mel_channels=20, cfm_dit_depth=2, cfm_dit_dim=64, cfm_dit_heads=4)
VOC = dict(V4, upsample_rates=(4, 4), upsample_initial_channel=64, upsample_kernel_sizes=(8, 8),
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))


def random_params(init, seed):
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def v4():
    jm = JV3(jconfig.S2Config(**V4))
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    params = random_params(lambda: jm.init(
        keys, jnp.zeros((1, 16, V4["ssl_dim"])), jnp.zeros((1, 16, V4["spec_channels"])), jnp.asarray([16]),
        jnp.zeros((1, 30, 20)), jnp.asarray([30]), jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]),
        method=JV3.init_all), seed=0)
    pm = SynthesizerTrnV3(pconfig.S2Config(**V4))
    pm.load_state_dict(s2v3_from_jax(params, pm.cfg), strict=True)
    return jm, params, pm.eval()


def _encp_inputs(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, V4["n_codes"], (1, 40))
    text = rng.integers(1, 700, (1, 23))
    spec = np.abs(rng.standard_normal((1, 50, V4["spec_channels"]))).astype(np.float32)
    return codes, text, spec


@pytest.mark.parametrize("speed", [1.0, 1.25])
def test_decode_encp_matches_jax(v4, speed):
    jm, params, pm = v4
    codes, text, spec = _encp_inputs(1)
    n, tl, sl = 37, 23, 50
    fj, gj, mj = jm.apply(params, jnp.asarray(codes, jnp.int32), jnp.asarray([n]), jnp.asarray(text, jnp.int32),
                          jnp.asarray([tl]), jnp.asarray(spec), jnp.asarray([sl]), speed=speed,
                          method=JV3.decode_encp)
    with torch.no_grad():
        fp, gp, mp = pm.decode_encp(torch.from_numpy(codes), torch.tensor([n]), torch.from_numpy(text),
                                    torch.tensor([tl]), torch.from_numpy(spec), torch.tensor([sl]), speed=speed)
    assert int(mp[0]) == int(mj[0])
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-5 * np.abs(gj).max())
    fj = np.asarray(fj)
    m = int(mj[0])  # frames past mel_len are masked to zero on both sides
    assert fp.shape == fj.shape
    # f32 through ~20 random-weight layers (outputs up to ~150) amplifies
    # rounding: the port's own f32 and f64 runs differ by ~1e-3 of the scale
    # and 3e-4 in mean relative error (the JAX f32 run and the port's f64
    # run by 1.5e-4), so the bars are 2e-3 of the scale and 1e-3 mean
    fp = fp.numpy()[:, :m]
    np.testing.assert_allclose(fp, fj[:, :m], rtol=1e-3, atol=2e-3 * np.abs(fj).max())
    assert np.abs(fp - fj[:, :m]).mean() / np.abs(fj[:, :m]).mean() < 1e-3


@pytest.mark.parametrize("cfg_rate", [0.0, 0.7])
def test_cfm_inference_same_noise(v4, cfg_rate):
    jm, params, pm = v4
    rng = np.random.default_rng(5)
    b, t, tp, mel = 2, 48, 12, V4["cfm_mel_channels"]
    mu = (0.5 * rng.standard_normal((b, t, 512))).astype(np.float32)
    prompt = (0.3 * rng.standard_normal((b, tp, mel))).astype(np.float32)
    lens = np.array([t, 40])
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (b, t, mel)))  # what j_cfm draws from key
    jdit = JDiT(jm.dit_config)
    want = np.asarray(j_cfm(jdit, {"params": params["params"]["cfm"]["estimator"]}, jnp.asarray(mu),
                            jnp.asarray(lens), jnp.asarray(prompt), key, n_steps=3, cfg_rate=cfg_rate, pad_t_to=0))
    got = cfm_inference(pm.cfm.estimator, torch.from_numpy(mu), torch.from_numpy(lens), torch.from_numpy(prompt),
                        noise=torch.from_numpy(noise), n_steps=3, cfg_rate=cfg_rate).numpy()
    assert got.shape == (b, t, mel)
    np.testing.assert_array_equal(got[:, :tp], 0.0)  # the prompt region stays zero
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=1e-3, atol=1e-4 * np.abs(want).max())


def test_cfm_padding_leaves_real_frames(v4):
    """pad_t_to (512 on a card) pads T; real frames move only by rounding."""
    _, _, pm = v4
    rng = np.random.default_rng(9)
    mu = torch.from_numpy((0.5 * rng.standard_normal((1, 40, 512))).astype(np.float32))
    prompt = torch.from_numpy((0.3 * rng.standard_normal((1, 8, 20))).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((1, 40, 20)).astype(np.float32))
    kw = dict(noise=noise, n_steps=2)
    a = cfm_inference(pm.cfm.estimator, mu, torch.tensor([40]), prompt, **kw)
    b = cfm_inference(pm.cfm.estimator, mu, torch.tensor([40]), prompt, pad_t_to=64, **kw)
    assert b.shape == a.shape
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-5 * float(a.abs().max()))


def test_mel_front_end_matches_jax():
    rng = np.random.default_rng(3)
    y = (0.3 * rng.standard_normal((1, 32000))).astype(np.float32)
    for cfg in ("MEL_V4", "MEL_V3"):
        jc, pc = getattr(jconfig, cfg), getattr(pconfig, cfg)
        assert jc == pc or (jc.__dict__ == pc.__dict__)
        np.testing.assert_array_equal(pmel.mel_filterbank(pc.sampling_rate, pc.n_fft, pc.num_mels),
                                      jmel.mel_filterbank(jc.sampling_rate, jc.n_fft, jc.num_mels))
        want = np.asarray(jmel.mel_spectrogram(jnp.asarray(y), jc))
        got = pmel.mel_spectrogram(torch.from_numpy(y), pc).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)  # log-mel; DFT vs FFT summation order
        np.testing.assert_allclose(pmel.norm_spec(torch.from_numpy(got)).numpy(), np.asarray(jmel.norm_spec(got)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pmel.denorm_spec(torch.from_numpy(got)).numpy(),
                                   np.asarray(jmel.denorm_spec(got)), rtol=1e-6, atol=1e-6)


def test_v4_vocoder_matches_jax():
    jcfg, pcfg = jconfig.S2Config(**VOC), pconfig.S2Config(**VOC)
    jg = JGen(jcfg, use_post_bias=True)
    params = random_params(lambda: jg.init(jax.random.PRNGKey(2), jnp.zeros((1, 10, 20))), seed=4)
    assert "cond" not in params["params"]
    pg = Generator(pcfg, in_channels=20, use_post_bias=True, conditioned=False)
    pg.load_state_dict(vocoder_v4_from_jax(params, pcfg), strict=True)
    mel = (np.random.default_rng(6).standard_normal((2, 30, 20)) * 0.5).astype(np.float32)
    want = np.asarray(jg.apply(params, jnp.asarray(mel)))
    with torch.no_grad():
        got = pg(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 30 * 16, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_sola_stitch_equal():
    rng = np.random.default_rng(8)
    for n_frag, overlap in ((1, 16), (2, 16), (4, 48)):
        frags = [rng.standard_normal(300).astype(np.float32) for _ in range(n_frag)]
        np.testing.assert_array_equal(sola_stitch(frags, overlap), j_sola([f.copy() for f in frags], overlap))


def test_mel_len_for_equal():
    for version in ("v3", "v4"):
        fake = types.SimpleNamespace(v3=types.SimpleNamespace(model=types.SimpleNamespace(
            cfg=types.SimpleNamespace(version=version))))
        for speed in (1.0, 0.8, 1.25, 2.0):
            for n in range(1, 400):
                assert ppipe.TTSPipeline._mel_len_for(fake, n, speed) == jpipe.TTSPipeline._mel_len_for(fake, n, speed)


def test_chunk_plan_and_assembly_equal():
    rng = np.random.default_rng(10)
    for chunk_len, overlap in ((1024 - 500, 12), (1000 - 500, 12), (48 - 12, 12)):
        stride = chunk_len - overlap
        for total in range(1, 3 * chunk_len):
            bs, padding_len, bs_pad = ppipe.v3_chunk_plan(total, chunk_len, overlap)
            # the JAX package's closed form (pipeline.py:1085-1088)
            jbs = max(1, -(-(total + overlap - chunk_len) // stride) + 1)
            assert (bs, padding_len, bs_pad) == (jbs, (jbs - 1) * stride + chunk_len - (total + overlap),
                                                 jpipe._next_bs_bucket(jbs))
            assert 0 <= padding_len < stride or bs == 1
        for total in (5, chunk_len - overlap, chunk_len, 2 * stride + 7):
            bs, _, bs_pad = ppipe.v3_chunk_plan(total, chunk_len, overlap)
            feats = rng.standard_normal((1, total, 6)).astype(np.float32)
            ref = rng.standard_normal((1, 9, 6)).astype(np.float32)
            want = np.asarray(jpipe._v3_assemble_chunks(jnp.asarray(feats), jnp.asarray(ref), bs=bs, bs_pad=bs_pad,
                                                        overlap=overlap, chunk_len=chunk_len))
            got = ppipe._v3_assemble_chunks(torch.from_numpy(feats), torch.from_numpy(ref), bs=bs, bs_pad=bs_pad,
                                            overlap=overlap, chunk_len=chunk_len).numpy()
            np.testing.assert_array_equal(got, want)
    assert ppipe._BS_BUCKETS == jpipe._BS_BUCKETS
