"""A tiny v3 TTSPipeline in each package (S1 + SynthesizerTrnV3 v3 + a tiny
BigVGAN + a tiny AP-BWE + CNHuBERT, built as tests/test_pipeline_v3.py
builds its pipeline), with the same weights carried across by the
converters, the same reference and text, in f32 with greedy S1 and the same
CFM noise fed to both sides (the JAX package's draws, through
`_cfm_noise`):

  * greedy S1 tokens equal;
  * the batched branch (`run`) at the vocoder's rate, the serial branch
    (`run(parallel_infer=False)`), and the batched branch with AP-BWE
    (`run(super_sampling=True)`, twice the rate): rate and length equal,
    the int16 waveform within LSB;
  * `run_streaming`: each fragment within LSB of the JAX package's, and
    the fragments concatenated equal to `run(split_bucket=False)` of the
    same seed in the port (serial branch on both).

The JAX pipeline maps the reference transcript's phone ids through the
symbol table a second time (`_v3_ref_features`, ROADMAP.md queue 3), so the
JAX side is given the phone strings. Its `run(parallel_infer=False)` hands
`early_stop_num` to `_synthesize_v3_batch`, which does not take it (a
TypeError, ROADMAP.md queue 3), so the JAX serial run is composed here from
`_synthesize_v3_batch` as `run` would compose it. The AP-BWE's phase-stream input
convolution is zeroed: the x2 resampled input's empty upper band has STFT
phases of round-off noise, different in the two FFTs
(tests/test_torch_apbwe.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.infer.pipeline import TTSPipeline as JPipe
from gpt_sovits_tpu.infer.pipeline import V3Bundle as JBundle
from gpt_sovits_tpu.models.apbwe import APBWEConfig as JSRCfg
from gpt_sovits_tpu.models.apbwe import APNetBWE as JSR
from gpt_sovits_tpu.models.bigvgan import BigVGAN as JBigVGAN
from gpt_sovits_tpu.models.bigvgan import BigVGANConfig as JVocCfg
from gpt_sovits_tpu.models.hubert import HubertConfig as JHubCfg
from gpt_sovits_tpu.models.hubert import HubertEncoder as JHub
from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3 as JV3
from gpt_sovits_tpu.text.cleaner import clean_text as j_clean_text
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline, V3Bundle
from gpt_sovits_tpu_torch.models.apbwe import APBWEConfig, APNetBWE
from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
from gpt_sovits_tpu_torch.utils import config as pconfig
from gpt_sovits_tpu_torch.weights import apbwe_from_jax, bigvgan_from_jax, hubert_from_jax, s1_from_jax, s2v3_from_jax

torch.set_num_threads(1)

HUB = dict(conv_dim=32, conv_kernels=(10, 3, 2), conv_strides=(5, 2, 2), hidden_size=48, num_layers=1,
           num_heads=4, intermediate_size=64, pos_conv_kernel=16, pos_conv_groups=4)
S1 = dict(vocab_size=33, phoneme_vocab_size=732, embedding_dim=48, hidden_dim=48, num_heads=4, ffn_dim=96,
          num_layers=2, eos_id=32, bert_dim=1024, max_len=2048, semantic_frame_rate=25)
V3 = dict(version="v3", spec_channels=65, inter_channels=32, hidden_channels=32, filter_channels=48, n_heads=2,
          n_layers=4, kernel_size=3, gin_channels=32, mrte_hidden=32, ssl_dim=48, n_codes=32,
          cfm_mel_channels=20, cfm_dit_depth=2, cfm_dit_dim=64, cfm_dit_heads=4)
VOC = dict(num_mels=20, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
SR = dict(n_fft=64, hop_size=16, win_size=64, channels=16, layers=1, hr_sampling_rate=12000)
MEL_SPEC = dict(sampling_rate=8000, n_fft=128, win_size=128, hop_size=64, num_mels=13)
MEL_CFM = dict(sampling_rate=6000, n_fft=64, win_size=64, hop_size=16, num_mels=20)
BUNDLE = dict(t_ref=12, t_chunk=48, out_sr=6000, sample_steps=2)
INFER = dict(min_ref_sec=0.1, max_ref_sec=30.0, batch_size=2)
REF_TEXT = "hello world"
TEXT = "Testing the flow matching path now. Short text! And a third piece here."
RUN = dict(seed=1, max_sec=2, top_k=1, cut_method="cut5")
# f32 on both sides, other summation orders through S2, the DiT, BigVGAN
# and AP-BWE: measured within 3 LSB
LSB = 4
V3_STD = 0.1


def random_params(init, seed, std=0.2):
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (std * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def vocoder_params(init, seed):
    """Per-channel snake parameters that differ, kernels of unit gain (the
    clamped output is not saturated)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1])
        std = 0.3 if ("alpha" in name or "beta" in name) else 0.05
        if "kernel" in name:
            std = 0.7 / np.sqrt(np.prod(s.shape[:-1]))
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def jax_noise(seed):
    """The CFM noise of the JAX batched branch for its i-th chunk batch of a
    run(seed=...) (run splits the key per group, _v3_launch once more)."""
    state = {"key": jax.random.PRNGKey(seed), "n": 0}

    def draw(shape, generator=None):
        state["key"], sub = jax.random.split(state["key"])
        _, sub2 = jax.random.split(sub)
        state["n"] += 1
        return torch.from_numpy(np.asarray(jax.random.normal(sub2, shape)))

    return draw, state


def jax_serial_noise(pp, monkeypatch, seed):
    """The CFM noise of the JAX serial branch (run and run_streaming split
    the key per S1 batch; every segment of a batch restarts from that key
    and splits it once per chunk), fed through the port's hooks."""
    state = {"key": jax.random.PRNGKey(seed), "group": None, "chunk": None, "n": 0}
    s1_launch, serial_mel = pp._s1_launch, pp._v3_serial_mel

    def s1(*a, **kw):
        state["key"], state["group"] = jax.random.split(state["key"])
        return s1_launch(*a, **kw)

    def mel(*a, **kw):
        state["chunk"] = state["group"]
        return serial_mel(*a, **kw)

    def draw(shape, generator=None):
        state["chunk"], sub = jax.random.split(state["chunk"])
        state["n"] += 1
        return torch.from_numpy(np.asarray(jax.random.normal(sub, shape)))

    monkeypatch.setattr(pp, "_s1_launch", s1)
    monkeypatch.setattr(pp, "_v3_serial_mel", mel)
    monkeypatch.setattr(pp, "_cfm_noise", draw)
    return state


def assert_within_lsb(wp, wj):
    assert wp.dtype == np.int16 and wp.shape == wj.shape
    assert np.abs(wj.astype(np.int32)).max() > 100  # non-trivial audio
    assert np.abs(wp.astype(np.int32) - wj.astype(np.int32)).max() <= LSB


@pytest.fixture(scope="module")
def pipes():
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    js1 = JT2S(jconfig.S1Config(**S1))
    s1p = random_params(lambda: js1.init(keys, method=JT2S.init_all), seed=0)
    jv3 = JV3(jconfig.S2Config(**V3))
    v3p = random_params(lambda: jv3.init(
        keys, jnp.zeros((1, 16, V3["ssl_dim"])), jnp.zeros((1, 16, V3["spec_channels"])), jnp.asarray([16]),
        jnp.zeros((1, 30, 20)), jnp.asarray([30]), jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]),
        method=JV3.init_all), seed=1, std=V3_STD)
    jvoc = JBigVGAN(JVocCfg(**VOC))
    vocp = vocoder_params(lambda: jvoc.init(jax.random.PRNGKey(2), jnp.zeros((1, 10, 20))), seed=2)
    jsr = JSR(JSRCfg(**SR))
    bins = SR["n_fft"] // 2 + 1
    srp = random_params(lambda: jsr.init(jax.random.PRNGKey(3), jnp.zeros((1, bins, 8)), jnp.zeros((1, bins, 8))),
                        seed=4, std=0.1)
    srp["params"]["conv_pre_pha"]["kernel"] = np.zeros_like(srp["params"]["conv_pre_pha"]["kernel"])
    jhub = JHub(JHubCfg(**HUB))
    hubp = random_params(lambda: jhub.init(jax.random.PRNGKey(0), jnp.zeros((1, 800))), seed=3)
    jp = JPipe(
        s1_model=js1, s1_params=s1p, s2_model=jv3, s2_params=None, hubert_model=jhub, hubert_params=hubp,
        mel_cfg=jconfig.MelConfig(**MEL_SPEC), infer_cfg=jconfig.InferenceConfig(**INFER),
        v3_bundle=JBundle(model=jv3, params=v3p, vocoder=jvoc, vocoder_params=vocp, sr_model=jsr, sr_params=srp,
                          mel_cfg=jconfig.MelConfig(**MEL_CFM), **BUNDLE),
        use_fused_s1=False, s1_weight_quant="bf16", s1_kv_quant="bf16", half=False,
    )
    s1 = T2SDecoder(pconfig.S1Config(**S1))
    s1.load_state_dict(s1_from_jax(s1p, s1.cfg), strict=True)
    v3 = SynthesizerTrnV3(pconfig.S2Config(**V3))
    v3.load_state_dict(s2v3_from_jax(v3p, v3.cfg), strict=True)
    voc = BigVGAN(BigVGANConfig(**VOC))
    voc.load_state_dict(bigvgan_from_jax(vocp, voc.cfg), strict=True)
    sr_model = APNetBWE(APBWEConfig(**SR))
    sr_model.load_state_dict(apbwe_from_jax(srp, sr_model.cfg), strict=True)
    hub = HubertEncoder(HubertConfig(**HUB))
    hub.load_state_dict(hubert_from_jax(hubp, hub.cfg), strict=True)
    pp = TTSPipeline(
        s1_model=s1, s2_model=None, hubert_model=hub, mel_cfg=pconfig.MelConfig(**MEL_SPEC),
        infer_cfg=pconfig.InferenceConfig(**INFER),
        v3_bundle=V3Bundle(model=v3, vocoder=voc, sr_model=sr_model, mel_cfg=pconfig.MelConfig(**MEL_CFM), **BUNDLE),
        use_fused_s1=False, s1_weight_quant="bf16", s1_kv_quant="bf16", half=False, device="cpu",
    )
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    jp.set_ref_audio(wav, sr=8000, ref_text=REF_TEXT, ref_lang="en")
    jp.ref.prompt_phones = j_clean_text(REF_TEXT, "en", "v3")[0]  # phone strings (module docstring)
    pp.set_ref_audio(wav, sr=8000, ref_text=REF_TEXT, ref_lang="en")
    return jp, pp


def test_s1_tokens_and_reference_features_equal(pipes):
    jp, pp = pipes
    np.testing.assert_array_equal(pp.ref.prompt_semantic, jp.ref.prompt_semantic)
    fj, _, mj, tj = jp._v3_ref_features()
    fp, _, mp, tp = pp._v3_ref_features()
    assert tp == tj and fp.shape == fj.shape
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-4, atol=2e-4)
    segs_j = jp.preprocess(TEXT, "en", "cut5")
    segs_p = pp.preprocess(TEXT, "en", "cut5")
    assert [s["phones"] for s in segs_p] == [s["phones"] for s in segs_j] and len(segs_p) == 3
    kw = dict(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=1.35, max_sec=2)
    out_j, _ = jp._s1_launch(segs_j, jax.random.PRNGKey(0), **kw)
    out_p, _ = pp._s1_launch(segs_p, torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(out_p.lengths.numpy(), np.asarray(out_j.lengths))
    np.testing.assert_array_equal(out_p.tokens.numpy(), np.asarray(out_j.tokens))


def test_batched_run_at_24k_rate(pipes, monkeypatch):
    jp, pp = pipes
    sr_j, wj = jp.run(TEXT, "en", super_sampling=False, **RUN)
    draw, state = jax_noise(RUN["seed"])
    monkeypatch.setattr(pp, "_cfm_noise", draw)
    sr_p, wp = pp.run(TEXT, "en", super_sampling=False, **RUN)
    assert state["n"] == 2 and sr_p == sr_j == BUNDLE["out_sr"]
    assert_within_lsb(wp, wj)
    assert set(pp.last_timing) == {"preprocess", "s1", "cfm", "vocoder"}
    # every segment's length follows from its S1 token count
    up = BUNDLE["out_sr"] * MEL_CFM["hop_size"] // MEL_CFM["sampling_rate"]
    silence = int(BUNDLE["out_sr"] * pp.cfg.fragment_interval)
    assert len(wp) == sum(pp._mel_len_for(n, 1.0) * up for n in pp.last_tokens.values()) + 2 * silence


def jax_serial_run(jp, text, *, seed, max_sec, top_k, cut_method):
    """The JAX run(parallel_infer=False) of a v3/v4 pipeline: one segment
    per group, the key split per group, silences between the segments."""
    cfg = jp.cfg
    key = jax.random.PRNGKey(seed)
    pieces = []
    for seg in jp.preprocess(text, "en", cut_method):
        key, sub = jax.random.split(key)
        pieces += jp._synthesize_v3_batch(
            [seg], sub, top_k=top_k, top_p=cfg.top_p, temperature=cfg.temperature,
            repetition_penalty=cfg.repetition_penalty, speed=1.0, max_sec=max_sec, super_sampling=False)
        pieces.append(np.zeros(int(jp.v3.out_sr * cfg.fragment_interval), np.float32))
    return jp.v3.out_sr, (np.clip(np.concatenate(pieces[:-1]), -1.0, 1.0) * 32767.0).astype(np.int16)


def test_serial_run(pipes, monkeypatch):
    jp, pp = pipes
    sr_j, wj = jax_serial_run(jp, TEXT, **RUN)
    state = jax_serial_noise(pp, monkeypatch, RUN["seed"])
    sr_p, wp = pp.run(TEXT, "en", parallel_infer=False, super_sampling=False, **RUN)
    chunk_len = BUNDLE["t_chunk"] - pp._v3_ref_features()[3]
    frames = [pp._mel_len_for(n, 1.0) for n in pp.last_tokens.values()]
    assert state["n"] == sum(-(-f // chunk_len) for f in frames) == len(pp.last_cfm_batch) > 3  # rolling chunks
    assert sr_p == sr_j == BUNDLE["out_sr"]
    assert_within_lsb(wp, wj)


def test_super_sampling_run(pipes, monkeypatch):
    jp, pp = pipes
    sr_j, wj = jp.run(TEXT, "en", super_sampling=True, **RUN)
    draw, _ = jax_noise(RUN["seed"])
    monkeypatch.setattr(pp, "_cfm_noise", draw)
    sr_p, wp = pp.run(TEXT, "en", super_sampling=True, **RUN)
    assert sr_p == sr_j == SR["hr_sampling_rate"] == pp.output_rate()
    assert_within_lsb(wp, wj)
    assert set(pp.last_timing) == {"preprocess", "s1", "cfm", "vocoder", "apbwe"}


def test_streaming_matches_jax_and_run(pipes, monkeypatch):
    jp, pp = pipes
    kw = dict(RUN, super_sampling=False)
    frags_j = list(jp.run_streaming(TEXT, "en", **kw))
    with monkeypatch.context() as m:
        jax_serial_noise(pp, m, RUN["seed"])
        frags_p = list(pp.run_streaming(TEXT, "en", **kw))
    assert len(frags_p) == len(frags_j) == 3 and pp.last_ttfb > 0
    for (sr_p, fp), (sr_j, fj) in zip(frags_p, frags_j):
        assert sr_p == sr_j == BUNDLE["out_sr"]
        assert_within_lsb(fp, fj)
    # the fragments, each followed by the silence, are run's output
    kw1 = dict(kw, parallel_infer=False)
    streamed = np.concatenate([f for _, f in pp.run_streaming(TEXT, "en", **kw1)])
    _, whole = pp.run(TEXT, "en", split_bucket=False, **kw1)
    silence = int(BUNDLE["out_sr"] * pp.cfg.fragment_interval)
    np.testing.assert_array_equal(streamed[: len(whole)], whole)
    assert len(streamed) == len(whole) + silence and not streamed[len(whole):].any()
