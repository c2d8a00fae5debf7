"""A tiny v4 TTSPipeline in each package (S1 + SynthesizerTrnV3 + the
HiFiGAN vocoder + CNHuBERT, built as tests/test_pipeline_v3.py builds its
pipeline), with the same weights, reference and text, in f32 with greedy S1
and the same CFM noise fed to both sides: prompt codes and S1 tokens equal,
output rate and length equal, the int16 waveform within a stated number of
LSB, on the batched branch, the serial branch and `run_streaming` (the
serial branch's JAX side and noise hooks are tests/test_torch_pipeline_v3.py's).
A V3Bundle also takes v3's BigVGAN as its vocoder.

The JAX pipeline maps the reference transcript's phone ids through the
symbol table a second time (`_v3_ref_features`), which turns every id into
UNK; the port passes the ids as the upstream project does (ROADMAP.md
queue 3). So the JAX side is given the phone strings, which its second
mapping turns into the same ids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.infer.pipeline import TTSPipeline as JPipe
from gpt_sovits_tpu.infer.pipeline import V3Bundle as JBundle
from gpt_sovits_tpu.models.hubert import HubertConfig as JHubCfg
from gpt_sovits_tpu.models.hubert import HubertEncoder as JHub
from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3 as JV3
from gpt_sovits_tpu.models.vits import Generator as JGen
from gpt_sovits_tpu.text.cleaner import clean_text as j_clean_text
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline, V3Bundle
from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
from gpt_sovits_tpu_torch.models.vits import Generator
from gpt_sovits_tpu_torch.utils import config as pconfig
from gpt_sovits_tpu_torch.weights import hubert_from_jax, s1_from_jax, s2v3_from_jax, vocoder_v4_from_jax
from test_torch_pipeline_v3 import jax_serial_noise, jax_serial_run

torch.set_num_threads(1)

HUB = dict(conv_dim=32, conv_kernels=(10, 3, 2), conv_strides=(5, 2, 2), hidden_size=48, num_layers=1,
           num_heads=4, intermediate_size=64, pos_conv_kernel=16, pos_conv_groups=4)
S1 = dict(vocab_size=33, phoneme_vocab_size=732, embedding_dim=48, hidden_dim=48, num_heads=4, ffn_dim=96,
          num_layers=2, eos_id=32, bert_dim=1024, max_len=2048, semantic_frame_rate=25)
V4 = dict(version="v4", spec_channels=65, inter_channels=32, hidden_channels=32, filter_channels=48, n_heads=2,
          n_layers=4, kernel_size=3, gin_channels=32, mrte_hidden=32, ssl_dim=48, n_codes=32,
          cfm_mel_channels=20, cfm_dit_depth=2, cfm_dit_dim=64, cfm_dit_heads=4)
VOC = dict(V4, upsample_rates=(4, 4), upsample_initial_channel=64, upsample_kernel_sizes=(8, 8),
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
MEL_SPEC = dict(sampling_rate=8000, n_fft=128, win_size=128, hop_size=64, num_mels=13)
MEL_CFM = dict(sampling_rate=6000, n_fft=64, win_size=64, hop_size=16, num_mels=20)
BUNDLE = dict(t_ref=12, t_chunk=48, out_sr=6000 * 16 // 16, sample_steps=2)
INFER = dict(min_ref_sec=0.1, max_ref_sec=30.0, batch_size=2)
REF_TEXT = "hello world"
TEXT = "Testing the flow matching path now. Short text! And a third piece here."
RUN = dict(seed=1, max_sec=2, top_k=1, cut_method="cut5")
# f32 on both sides, other summation orders: 1 LSB apart where measured
LSB = 2
# weight scales at which the random vocoder's tanh is not saturated (at 0.2
# two-thirds of the samples sit at full scale, where a flip costs 2^16 LSB)
V3_STD, VOC_STD = 0.1, 0.05


def random_params(init, seed, std=0.2):
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (std * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def jax_noise(seed):
    """The CFM noise the JAX pipeline draws for its i-th chunk batch of a
    run(seed=...) (run splits the key per group, _v3_launch once more)."""
    state = {"key": jax.random.PRNGKey(seed), "n": 0}

    def draw(shape, generator=None):
        state["key"], sub = jax.random.split(state["key"])
        _, sub2 = jax.random.split(sub)
        state["n"] += 1
        return torch.from_numpy(np.asarray(jax.random.normal(sub2, shape)))

    return draw, state


@pytest.fixture(scope="module")
def pipes():
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    js1 = JT2S(jconfig.S1Config(**S1))
    s1p = random_params(lambda: js1.init(keys, method=JT2S.init_all), seed=0)
    jv3 = JV3(jconfig.S2Config(**V4))
    v3p = random_params(lambda: jv3.init(
        keys, jnp.zeros((1, 16, V4["ssl_dim"])), jnp.zeros((1, 16, V4["spec_channels"])), jnp.asarray([16]),
        jnp.zeros((1, 30, 20)), jnp.asarray([30]), jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]),
        method=JV3.init_all), seed=1, std=V3_STD)
    jvoc = JGen(jconfig.S2Config(**VOC), use_post_bias=True)
    vocp = random_params(lambda: jvoc.init(jax.random.PRNGKey(2), jnp.zeros((1, 10, 20))), seed=2, std=VOC_STD)
    jhub = JHub(JHubCfg(**HUB))
    hubp = random_params(lambda: jhub.init(jax.random.PRNGKey(0), jnp.zeros((1, 800))), seed=3)
    jp = JPipe(
        s1_model=js1, s1_params=s1p, s2_model=jv3, s2_params=None, hubert_model=jhub, hubert_params=hubp,
        mel_cfg=jconfig.MelConfig(**MEL_SPEC), infer_cfg=jconfig.InferenceConfig(**INFER),
        v3_bundle=JBundle(model=jv3, params=v3p, vocoder=jvoc, vocoder_params=vocp,
                          mel_cfg=jconfig.MelConfig(**MEL_CFM), **BUNDLE),
        use_fused_s1=False, s1_weight_quant="bf16", s1_kv_quant="bf16", half=False,
    )
    s1 = T2SDecoder(pconfig.S1Config(**S1))
    s1.load_state_dict(s1_from_jax(s1p, s1.cfg), strict=True)
    v3 = SynthesizerTrnV3(pconfig.S2Config(**V4))
    v3.load_state_dict(s2v3_from_jax(v3p, v3.cfg), strict=True)
    voc = Generator(pconfig.S2Config(**VOC), in_channels=20, use_post_bias=True, conditioned=False)
    voc.load_state_dict(vocoder_v4_from_jax(vocp, voc_cfg := pconfig.S2Config(**VOC)), strict=True)
    assert voc_cfg.upsample_rates == (4, 4)
    hub = HubertEncoder(HubertConfig(**HUB))
    hub.load_state_dict(hubert_from_jax(hubp, hub.cfg), strict=True)
    pp = TTSPipeline(
        s1_model=s1, s2_model=None, hubert_model=hub, mel_cfg=pconfig.MelConfig(**MEL_SPEC),
        infer_cfg=pconfig.InferenceConfig(**INFER),
        v3_bundle=V3Bundle(model=v3, vocoder=voc, mel_cfg=pconfig.MelConfig(**MEL_CFM), **BUNDLE),
        use_fused_s1=False, s1_weight_quant="bf16", s1_kv_quant="bf16", half=False, device="cpu",
    )
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    jp.set_ref_audio(wav, sr=8000, ref_text=REF_TEXT, ref_lang="en")
    jp.ref.prompt_phones = j_clean_text(REF_TEXT, "en", "v4")[0]  # phone strings (module docstring)
    pp.set_ref_audio(wav, sr=8000, ref_text=REF_TEXT, ref_lang="en")
    return jp, pp


def test_prompt_codes_and_reference_features_equal(pipes):
    jp, pp = pipes
    np.testing.assert_array_equal(pp.ref.prompt_semantic, jp.ref.prompt_semantic)
    fj, gj, mj, tj = jp._v3_ref_features()
    fp, gp, mp, tp = pp._v3_ref_features()
    assert tp == tj and fp.shape == fj.shape and mp.shape == mj.shape
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), rtol=1e-3, atol=2e-3 * np.abs(np.asarray(fj)).max())


def test_s1_tokens_equal(pipes):
    jp, pp = pipes
    segs_j = jp.preprocess(TEXT, "en", "cut5")
    segs_p = pp.preprocess(TEXT, "en", "cut5")
    assert [s["phones"] for s in segs_p] == [s["phones"] for s in segs_j] and len(segs_p) == 3
    kw = dict(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=1.35, max_sec=2)
    out_j, _ = jp._s1_launch(segs_j, jax.random.PRNGKey(0), **kw)
    out_p, _ = pp._s1_launch(segs_p, torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(out_p.lengths.numpy(), np.asarray(out_j.lengths))
    np.testing.assert_array_equal(out_p.tokens.numpy(), np.asarray(out_j.tokens))


def test_run_waveform_within_lsb(pipes, monkeypatch):
    jp, pp = pipes
    sr_j, wj = jp.run(TEXT, "en", **RUN)
    draw, state = jax_noise(RUN["seed"])
    monkeypatch.setattr(pp, "_cfm_noise", draw)
    sr_p, wp = pp.run(TEXT, "en", **RUN)
    assert state["n"] == 2  # two segment groups (batch_size 2), one CFM call each
    assert sr_p == sr_j == BUNDLE["out_sr"] and wp.dtype == np.int16
    assert wp.shape == wj.shape
    assert np.abs(wj.astype(np.int32)).max() > 100  # non-trivial audio
    assert np.abs(wp.astype(np.int32) - wj.astype(np.int32)).max() <= LSB
    assert set(pp.last_timing) == {"preprocess", "s1", "cfm", "vocoder"}
    assert all(bs >= 1 and bs_pad >= bs for bs, bs_pad in pp.last_cfm_batch) and len(pp.last_cfm_batch) == 2


def test_serial_run_within_lsb(pipes, monkeypatch):
    jp, pp = pipes
    sr_j, wj = jax_serial_run(jp, TEXT, **RUN)
    state = jax_serial_noise(pp, monkeypatch, RUN["seed"])
    sr_p, wp = pp.run(TEXT, "en", parallel_infer=False, **RUN)
    assert state["n"] == len(pp.last_cfm_batch) > 3 and sr_p == sr_j == BUNDLE["out_sr"]
    assert wp.shape == wj.shape and np.abs(wj.astype(np.int32)).max() > 100
    assert np.abs(wp.astype(np.int32) - wj.astype(np.int32)).max() <= LSB


def test_streaming_within_lsb(pipes, monkeypatch):
    jp, pp = pipes
    frags_j = list(jp.run_streaming(TEXT, "en", **RUN))
    jax_serial_noise(pp, monkeypatch, RUN["seed"])
    frags_p = list(pp.run_streaming(TEXT, "en", **RUN))
    assert len(frags_p) == len(frags_j) == 3 and pp.last_ttfb > 0
    for (sr_p, fp), (sr_j, fj) in zip(frags_p, frags_j):
        assert sr_p == sr_j == BUNDLE["out_sr"] and fp.shape == fj.shape
        assert np.abs(fp.astype(np.int32) - fj.astype(np.int32)).max() <= LSB


def test_bigvgan_vocoder_bundle(pipes):
    """A V3Bundle takes a BigVGAN vocoder (x16 here, as the mel's hop to the
    output rate asks); anything else is refused."""
    _, pp = pipes
    voc = BigVGAN(BigVGANConfig(num_mels=20, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                                upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                                resblock_dilation_sizes=((1, 3),)))
    bp = TTSPipeline(s1_model=pp.s1, s2_model=None, hubert_model=pp.hubert, device="cpu",
                     infer_cfg=pp.cfg, mel_cfg=pp.mel_cfg,
                     v3_bundle=V3Bundle(model=pp.v3.model, vocoder=voc, mel_cfg=pp.v3.mel_cfg, **BUNDLE),
                     use_fused_s1=False, s1_weight_quant="bf16", s1_kv_quant="bf16", half=False)
    bp.ref = pp.ref
    sr, wav = bp.run(TEXT, "en", **RUN)
    up = BUNDLE["out_sr"] * bp.v3.mel_cfg.hop_size // bp.v3.mel_cfg.sampling_rate
    silence = int(sr * bp.cfg.fragment_interval)
    assert sr == BUNDLE["out_sr"] and wav.dtype == np.int16
    assert len(wav) == sum(bp._mel_len_for(n, 1.0) * up for n in bp.last_tokens.values()) + 2 * silence
    with pytest.raises(TypeError, match="vocoder"):
        TTSPipeline(s1_model=pp.s1, s2_model=None, hubert_model=pp.hubert, device="cpu",
                    v3_bundle=V3Bundle(model=pp.v3.model, vocoder=object(), mel_cfg=pp.v3.mel_cfg, **BUNDLE))


def test_reference_text_required(pipes):
    _, pp = pipes
    rng = np.random.default_rng(1)
    ref = pp.ref
    try:
        pp.set_ref_audio((rng.standard_normal(8000) * 0.1).astype(np.float32), sr=8000)  # no transcript
        with pytest.raises(ValueError, match="reference text"):
            pp.run("hello there friend", "en", max_sec=1)
    finally:
        pp.ref = ref
