"""A tiny v2ProPlus TTSPipeline in each package, with the same weights, the
same 4 s synthetic reference and the same two-segment English text, greedy
and in f32 on both sides (plain S1 step, bf16/bf16 quant settings, f32
vocoder). Both have the same 3-layer BERT at hidden 1024 (the width the
pipelines' zero features assume) and one WordPiece tokenizer, for the zh,
zh-English and auto requests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.infer.pipeline import TTSPipeline as JPipe
from gpt_sovits_tpu.models.eres2net import ERes2NetConfig as JSVConfig
from gpt_sovits_tpu.models.eres2net import ERes2NetV2 as JSV
from gpt_sovits_tpu.models.hubert import HubertConfig as JHubCfg
from gpt_sovits_tpu.models.hubert import HubertEncoder as JHub
from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.models.vits import SynthesizerTrn as JSynth
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline
from gpt_sovits_tpu_torch.models.bert import BertConfig
from gpt_sovits_tpu_torch.models.eres2net import ERes2NetConfig, ERes2NetV2
from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.text.bert_tokenizer import BertTokenizer
from gpt_sovits_tpu_torch.text.cleaner import clean_text as p_clean
from gpt_sovits_tpu_torch.text.lang_segmenter import runs_for_language
from gpt_sovits_tpu_torch.utils import config as pconfig
from gpt_sovits_tpu_torch.weights import eres2net_from_jax, hubert_from_jax, s1_from_jax, s2_from_jax
from test_torch_bert import CFG as BERT_CFG
from test_torch_bert import JBert, JBertConfig, bert_params, port_bert

torch.set_num_threads(1)

HUB = dict(conv_dim=32, conv_kernels=(10, 3, 2), conv_strides=(5, 2, 2), hidden_size=48, num_layers=1,
           num_heads=4, intermediate_size=64, pos_conv_kernel=16, pos_conv_groups=4)
S1 = dict(vocab_size=41, phoneme_vocab_size=732, embedding_dim=48, hidden_dim=48, num_heads=4, ffn_dim=96,
          num_layers=2, eos_id=40, bert_dim=1024, max_len=1024, semantic_frame_rate=25)
SV = dict(num_blocks=(1, 1, 1, 1), m_channels=4, feat_dim=80, base_width=24, scale=4, expansion=4)
SV_DIM = 4 * 8 * 4 * (80 // 8)
S2 = dict(version="v2ProPlus", spec_channels=65, segment_size=8, inter_channels=32, hidden_channels=32,
          filter_channels=48, n_heads=2, n_layers=4, kernel_size=3, upsample_rates=(4, 4),
          upsample_initial_channel=96, upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,),
          resblock_dilation_sizes=((1, 3),), gin_channels=48, mrte_hidden=32, ssl_dim=48, n_codes=40, sv_dim=SV_DIM)
MEL = dict(sampling_rate=8000, n_fft=128, win_size=128, hop_size=64, num_mels=13)
INFER = dict(min_ref_sec=0.1, max_ref_sec=30.0, batch_size=4)
TEXT = "Hello world this is the first segment. And here comes the second one!"
RUN = dict(seed=3, max_sec=2, top_k=1, cut_method="cut5")
# (text, language mode): zh with numbers, a date and sandhi words; zh-English
# in "zh" mode; auto over zh, ja and en runs
ZH_REQUESTS = [
    ("今天是2024年3月5日，银行行长说你好。我们一起去看看吧！不要不要，一个一个来。", "zh"),
    ("我在用iPhone工作，OK吗？这个很好。", "zh"),
    ("你好世界，今天天气很好。こんにちは、元気ですか。Hello there, my friend.", "auto"),
]
ZH_REF_TEXT = "这是参考音频的文本，说得很清楚。"


def bert_vocab() -> list[str]:
    """chinese-roberta's layout ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102,
    [MASK] 103) over the characters of the test texts' zh runs."""
    chars = set()
    for text, _ in ZH_REQUESTS + [(ZH_REF_TEXT, "zh")]:
        chars |= set(p_clean(text, "zh")[2])
    return ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(chars)


# int16 output: f32 on both sides, other summation orders through S2 and
# the vocoder (1e-4 relative at most, test_torch_vits.py) -> a few LSB
LSB = 8


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


@pytest.fixture(scope="module")
def pipes():
    js1 = JT2S(jconfig.S1Config(**S1))
    s1p = random_params(js1, method=JT2S.init_all)
    js2 = JSynth(jconfig.S2Config(**S2))
    s2p = random_params(
        js2, jnp.zeros((1, 8, S2["ssl_dim"])), jnp.zeros((1, 10, S2["spec_channels"])),
        jnp.asarray([10]), jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]),
        sv_emb=jnp.zeros((1, SV_DIM)), method=JSynth.init_all, seed=1,
    )
    jhub = JHub(JHubCfg(**HUB))
    hubp = random_params(jhub, jnp.zeros((1, 800)), seed=2)
    jsv = JSV(JSVConfig(**SV))
    svp = random_params(jsv, jnp.zeros((1, 32, 80)), seed=3)
    tok = BertTokenizer(bert_vocab())
    assert len(tok) <= BERT_CFG["vocab_size"]
    jbert_cfg = JBertConfig(**BERT_CFG)
    bertp = bert_params(jbert_cfg, seed=4)
    jp = JPipe(
        s1_model=js1, s1_params=s1p, s2_model=js2, s2_params=s2p, hubert_model=jhub, hubert_params=hubp,
        sv_model=jsv, sv_params=svp, bert_model=JBert(jbert_cfg), bert_params=bertp, bert_tokenizer=tok,
        mel_cfg=jconfig.MelConfig(**MEL),
        infer_cfg=jconfig.InferenceConfig(**INFER), use_fused_s1=False, s1_weight_quant="bf16",
        s1_kv_quant="bf16", half=False,
    )
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    s1 = T2SDecoder(pconfig.S1Config(**S1))
    s1.load_state_dict(s1_from_jax(np_tree(s1p), s1.cfg), strict=True)
    s2 = SynthesizerTrn(pconfig.S2Config(**S2))
    s2.load_state_dict(s2_from_jax(np_tree(s2p), s2.cfg), strict=True)
    hub = HubertEncoder(HubertConfig(**HUB))
    hub.load_state_dict(hubert_from_jax(np_tree(hubp), hub.cfg), strict=True)
    sv = ERes2NetV2(ERes2NetConfig(**SV))
    sv.load_state_dict(eres2net_from_jax(np_tree(svp), sv.cfg), strict=True)
    pp = TTSPipeline(
        s1_model=s1, s2_model=s2, hubert_model=hub, sv_model=sv,
        bert_model=port_bert(bertp, BertConfig(**BERT_CFG)), bert_tokenizer=tok, mel_cfg=pconfig.MelConfig(**MEL),
        infer_cfg=pconfig.InferenceConfig(**INFER), use_fused_s1=False, s1_weight_quant="bf16",
        s1_kv_quant="bf16", half=False, device="cpu",
    )
    rng = np.random.default_rng(0)
    t = np.arange(4 * 8000) / 8000.0
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    jp.set_ref_audio(wav, sr=8000)
    pp.set_ref_audio(wav, sr=8000)
    return jp, pp


def test_prompt_codes_equal(pipes):
    jp, pp = pipes
    np.testing.assert_array_equal(pp.ref.prompt_semantic, jp.ref.prompt_semantic)
    np.testing.assert_allclose(pp.ref.refer_spec, jp.ref.refer_spec, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(pp.ref.sv_emb, jp.ref.sv_emb, rtol=1e-3, atol=1e-4 * np.abs(jp.ref.sv_emb).max())


def test_s1_tokens_equal(pipes):
    jp, pp = pipes
    segs_j = jp.preprocess(TEXT, "en", "cut5")
    segs_p = pp.preprocess(TEXT, "en", "cut5")
    assert len(segs_p) == 2
    assert [s["phones"] for s in segs_p] == [s["phones"] for s in segs_j]
    kw = dict(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=1.35, max_sec=2)
    out_j, _ = jp._s1_launch(segs_j, jax.random.PRNGKey(0), **kw)
    out_p, _ = pp._s1_launch(segs_p, torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(out_p.lengths.numpy(), np.asarray(out_j.lengths))
    np.testing.assert_array_equal(out_p.tokens.numpy(), np.asarray(out_j.tokens))


def test_run_waveform_within_lsb(pipes):
    jp, pp = pipes
    sr_j, wj = jp.run(TEXT, "en", **RUN)
    sr_p, wp = pp.run(TEXT, "en", **RUN)
    assert sr_p == sr_j and wp.dtype == np.int16
    assert wp.shape == wj.shape
    assert np.abs(wj.astype(np.int32)).max() > 100  # non-trivial audio
    assert np.abs(wp.astype(np.int32) - wj.astype(np.int32)).max() <= LSB
    assert set(pp.last_timing) == {"preprocess", "s1", "s2"}


def test_device_default_is_cuda(pipes):
    """device=None means the card; without one the pipeline raises."""
    _, pp = pipes
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSPipeline(s1_model=pp.s1, s2_model=pp.s2, hubert_model=pp.hubert)


@pytest.mark.parametrize("req", range(len(ZH_REQUESTS)))
def test_zh_preprocess_matches_jax(pipes, req):
    """Identical phones; BERT features allclose at 1e-4; over the whole
    text, non-zero feature rows exactly on the phones of its zh runs."""
    jp, pp = pipes
    text, lang = ZH_REQUESTS[req]
    segs_j = jp.preprocess(text, lang, "cut5")
    segs_p = pp.preprocess(text, lang, "cut5")
    assert [s["phones"] for s in segs_p] == [s["phones"] for s in segs_j]
    assert [s["norm_text"] for s in segs_p] == [s["norm_text"] for s in segs_j]
    for sp, sj in zip(segs_p, segs_j):
        assert sp["bert"].shape == (len(sp["phones"]), 1024)
        np.testing.assert_allclose(sp["bert"], sj["bert"], rtol=1e-4, atol=1e-4)
    ids, bert, _ = pp._g2p_segment(text, lang)
    zh = np.concatenate([np.full(len(p_clean(r["text"], r["lang"])[0]), r["lang"] == "zh")
                         for r in runs_for_language(text, lang)])
    assert len(ids) == len(zh) == bert.shape[0] and zh.any() and (req == 0 or not zh.all())
    np.testing.assert_array_equal(np.abs(bert).sum(-1) > 0, zh)


def test_zh_s1_tokens_equal(pipes):
    jp, pp = pipes
    text, lang = ZH_REQUESTS[0]
    segs_j = jp.preprocess(text, lang, "cut5")
    segs_p = pp.preprocess(text, lang, "cut5")
    assert len(segs_p) >= 2
    kw = dict(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=1.35, max_sec=2)
    out_j, _ = jp._s1_launch(segs_j, jax.random.PRNGKey(0), **kw)
    out_p, _ = pp._s1_launch(segs_p, torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(out_p.lengths.numpy(), np.asarray(out_j.lengths))
    np.testing.assert_array_equal(out_p.tokens.numpy(), np.asarray(out_j.tokens))


def test_zh_run_returns_audio(pipes):
    """A zh request (which raised NotImplementedError before the zh frontend
    was ported) returns audio within LSB of the JAX package's; "auto" is the
    default language, as in the JAX package."""
    jp, pp = pipes
    text, _ = ZH_REQUESTS[0]
    sr_j, wj = jp.run(text, "zh", **RUN)
    sr_p, wp = pp.run(text, "zh", **RUN)
    assert sr_p == sr_j and wp.dtype == np.int16 and wp.shape == wj.shape
    assert np.abs(wj.astype(np.int32)).max() > 100
    assert np.abs(wp.astype(np.int32) - wj.astype(np.int32)).max() <= LSB
    _, wa = pp.run(text, **RUN)
    np.testing.assert_array_equal(wa, wp)  # auto labels this text zh throughout


def test_set_ref_audio_zh_transcript(pipes):
    """set_ref_audio with a zh transcript (ref_lang defaults to "auto") gives
    the JAX package's prompt phones."""
    jp, pp = pipes
    saved = jp.ref, pp.ref
    try:
        wav = np.asarray(pp.ref.raw_wav)
        jr = jp.set_ref_audio(wav, sr=8000, ref_text=ZH_REF_TEXT)
        pr = pp.set_ref_audio(wav, sr=8000, ref_text=ZH_REF_TEXT)
        assert pr.prompt_phones == jr.prompt_phones and pr.prompt_phones
        np.testing.assert_array_equal(pr.prompt_semantic, jr.prompt_semantic)
    finally:
        jp.ref, pp.ref = saved


def test_run_streaming_matches_jax_and_run(pipes):
    """run_streaming (S1 and S2 with one batch in flight): each fragment
    within LSB of the JAX package's, and the fragments, each followed by the
    inter-fragment silence, equal to run(split_bucket=False) of the same
    seed."""
    jp, pp = pipes
    frags_j = list(jp.run_streaming(TEXT, "en", batch_size=1, **RUN))
    frags_p = list(pp.run_streaming(TEXT, "en", batch_size=1, **RUN))
    assert len(frags_p) == len(frags_j) == 2 and pp.last_ttfb > 0
    for (sr_p, fp), (sr_j, fj) in zip(frags_p, frags_j):
        assert sr_p == sr_j == MEL["sampling_rate"] and fp.dtype == np.int16 and fp.shape == fj.shape
        assert np.abs(fp.astype(np.int32) - fj.astype(np.int32)).max() <= LSB
    streamed = np.concatenate([f for _, f in frags_p])
    _, whole = pp.run(TEXT, "en", split_bucket=False, batch_size=1, **RUN)
    silence = int(MEL["sampling_rate"] * pp.cfg.fragment_interval)
    np.testing.assert_array_equal(streamed[: len(whole)], whole)
    assert len(streamed) == len(whole) + silence and not streamed[len(whole):].any()
