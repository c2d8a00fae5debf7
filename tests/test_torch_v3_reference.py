"""The port's v3 vocoder stage against the benchmark's plain reference
(bench_port/reference/bigvgan.py, apbwe.py; bench_port/families/cfm_sr.py
`SRVoiceReference`), on the CPU at small widths, both sides filled from one
seed by the benchmark's weight streams (bench_port/weights.py):

  * BigVGAN with `use_kernel=True` (on the CPU, K6's plain twin) and with
    `use_kernel=False`;
  * AP-BWE's STFT, model and iSTFT, and `super_resolve` whole;
  * the v3 chain through `TTSPipeline`: a CFM output -> BigVGAN -> SOLA ->
    AP-BWE (`_v3_vocode`, `_v3_fetch`, `_apbwe`) against the reference's
    `vocode_group` and AP-BWE on the same mel;
  * a reference with a planted fault (α and β swapped, one filter tap
    dropped) is far outside the tolerance, and the parameter names line up.

Nothing here imports JAX. The widths keep the published rates, kernels,
dilations, n_fft, hop and mel bins; only channels and depths are cut.
"""

import copy

import numpy as np
import pytest
import torch

from bench_port.families import cfm_sr
from bench_port.reference import apbwe as ref_apbwe
from bench_port.reference import bigvgan as ref_bigvgan
from bench_port.reference import voice
from bench_port.tests import tiny
from bench_port.weights import fill
from gpt_sovits_tpu_torch.models import apbwe as port_apbwe
from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.utils.config import MEL_V3
from gpt_sovits_tpu_torch.utils.metrics import PhaseTimer

torch.set_num_threads(2)

SEED = 2**31 + 18
# float32 on both sides, the same operations in the same order (BigVGAN
# reads 0.0 on this CPU); the room is for another summation order of the
# convolutions and, for AP-BWE, the iSTFT's polar against cos/sin, each
# a few float32 steps (1e-7) relative; a fault reads 0.07 and more
TOL = 1e-5
# the int16 waveforms of the chain: both sides truncate the same f32 values
# to int16, so a sample differs by at most one step where a value lies
# within rounding of a step's edge (and SOLA then mixes two such samples)
LSB = 2.0 / 32767


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    assert a.shape == b.shape
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def cfg():
    """The v3 configuration cut to small widths (tiny.config's S1, S2,
    HuBERT and DiT; BigVGAN from 64 channels, six stages down to 1; AP-BWE
    2 x 32), a short CFM window, and a gain that keeps BigVGAN's output off
    its clamp."""
    c = tiny.config("v3")
    c["vocoder"]["upsample_initial_channel"] = 64
    c["apbwe"].update(channels=32, layers=2)
    c["cfm"].update(t_ref=100, t_chunk=300)
    c["reference_audio"]["seconds"] = 3.0
    c["weights"]["gains"]["vocoder"]["conv_post.weight"] = 0.3
    return c


def pair_bigvgan(c: dict, use_kernel: bool):
    port = BigVGAN(BigVGANConfig(**{k: v for k, v in c.items() if k != "in_channels"}), use_kernel=use_kernel)
    ref = ref_bigvgan.BigVGAN(c)
    spec = {"gains": {"vocoder": {"conv_post.weight": 0.3}}}
    fill(port, SEED, "vocoder", spec)
    fill(ref, SEED, "vocoder", spec)
    return port.eval(), ref.eval()


def mel(frames: int, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return 2.0 * torch.randn(1, frames, 100, generator=g) - 6.0  # a log-mel's range


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_twin", "plain"])
def test_bigvgan_matches_the_reference(cfg, use_kernel):
    port, ref = pair_bigvgan(cfg["vocoder"], use_kernel)
    x = mel(9)
    with torch.no_grad():
        want = ref(x)
        got = port(x)
    assert got.shape == want.shape == (1, 9 * 256, 1)
    assert float((want.abs() >= 1.0).float().mean()) < 0.01  # the clamp hides nothing
    assert rel(got, want) < TOL


def test_a_broken_reference_is_far_off(cfg, monkeypatch):
    """α and β swapped in every snake, or one tap of the resampling filter
    dropped: the port is then orders of magnitude outside TOL."""
    port, ref = pair_bigvgan(cfg["vocoder"], True)
    x = mel(9)
    with torch.no_grad():
        got = port(x)
        swapped = copy.deepcopy(ref)
        for m in swapped.modules():
            if isinstance(m, ref_bigvgan.SnakeBeta):
                m.alpha, m.beta = m.beta, m.alpha
        assert rel(got, swapped(x)) > 1000 * TOL
        dropped = ref_bigvgan.FILTER.copy()
        dropped[0] = 0.0
        monkeypatch.setattr(ref_bigvgan, "FILTER", dropped / dropped.sum())
        assert rel(got, ref(x)) > 100 * TOL


def test_fill_names_line_up(cfg):
    """Parameter names and shapes are the same on both sides, so one seed
    gives both the same values."""
    port, ref = pair_bigvgan(cfg["vocoder"], True)
    pp, rp = dict(port.named_parameters()), dict(ref.named_parameters())
    assert pp.keys() == rp.keys() and all(torch.equal(pp[k], rp[k]) for k in pp)
    assert "resblocks.0.activations.5.act.beta" in pp and "activation_post.act.alpha" in pp
    pa = port_apbwe.APNetBWE(port_apbwe.APBWEConfig(**cfg["apbwe"]))
    ra = ref_apbwe.APNetBWE(cfg["apbwe"])
    fill(pa, SEED, "apbwe")
    fill(ra, SEED, "apbwe")
    pp, rp = dict(pa.named_parameters()), dict(ra.named_parameters())
    assert pp.keys() == rp.keys() and all(torch.equal(pp[k], rp[k]) for k in pp)
    assert "convnext_pha.1.gamma" in pp and "linear_post_pha_i.weight" in pp


def test_apbwe_stft_model_istft_match_the_reference(cfg):
    c = cfg["apbwe"]
    port = port_apbwe.APNetBWE(port_apbwe.APBWEConfig(**c)).eval()
    ref = ref_apbwe.APNetBWE(c).eval()
    fill(port, SEED, "apbwe")
    fill(ref, SEED, "apbwe")
    rng = np.random.default_rng(3)
    wav24 = (0.1 * rng.standard_normal(24000 // 4)).astype(np.float32)
    up = ref_apbwe.resample(wav24, 24000, 48000)
    assert np.array_equal(up, port_apbwe.resample(wav24, 24000, 48000))
    x = torch.from_numpy(up[None])
    mag_r, pha_r = ref_apbwe.amp_pha_stft(x, c)
    mag_p, pha_p = port_apbwe.amp_pha_stft(x, c["n_fft"], c["hop_size"], c["win_size"])
    assert torch.equal(mag_r, mag_p) and torch.equal(pha_r, pha_p)
    with torch.no_grad():
        out_r, out_p = ref(mag_r, pha_r), port(mag_p, pha_p)
    assert rel(out_p[0], out_r[0]) < TOL and rel(out_p[1], out_r[1]) < TOL
    assert rel(port_apbwe.amp_pha_istft(*out_r, c["n_fft"], c["hop_size"], c["win_size"]),
               ref_apbwe.amp_pha_istft(*out_r, c)) < TOL
    got, rate = port_apbwe.super_resolve(port, wav24[None], 24000)
    assert rate == 48000 and rel(got[0], ref.super_resolve(wav24, 24000)) < TOL


def test_v3_chain_through_the_pipeline_matches_the_reference(cfg):
    """A CFM output (three chunks, their bucket) through the
    pipeline's vocoder stage, SOLA and AP-BWE, against the reference's
    `vocode_group` and AP-BWE on the same mel."""
    pipe = cfm_sr.build(cfg, SEED, "cpu")
    ref = cfm_sr.SRVoiceReference(cfg, SEED, "cpu")
    voice.set_tf32(False)
    t_min = pipe._v3_ref_features()[3]
    c = cfg["cfm"]
    chunk_len, overlap = c["t_chunk"] - t_min, c["overlapped_len"]
    lens = [160, 220, 19]
    bs, padding_len, bucket = voice.chunk_plan(sum(lens), chunk_len, overlap)
    assert (bs, bucket) == (3, 3)
    g = torch.Generator().manual_seed(5)
    cfm_out = torch.rand(bucket, t_min + chunk_len, 100, generator=g) * 0.6 - 0.2
    up = c["out_sr"] * MEL_V3.hop_size // MEL_V3.sampling_rate
    mel_long = cfm_out[:bs, t_min:].reshape(1, bs * chunk_len, -1)
    got = pipe._v3_fetch(pipe._v3_vocode((mel_long, lens, bs, padding_len, chunk_len, overlap, up)))
    plan = {"bs": bs, "padding_len": padding_len, "chunk_len": chunk_len, "lens": lens}
    want = ref.vocode_group(cfm_out, plan, bucket, t_min)
    assert [len(w) for w in got] == [n * 256 for n in lens]
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= LSB
        assert np.abs(b).max() > 0.05  # a voice, not int16 rounding
    hr = pipe._apbwe(got, None, PhaseTimer())
    for x, y in zip(got, hr):
        assert rel(y, ref.apbwe.super_resolve(x, c["out_sr"])) < TOL
