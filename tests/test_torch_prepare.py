"""Data preparation in the port (prepare/extract.py, run.py `run_prepare`,
`latest_step_model`) against the JAX package's on a small corpus the test
writes: a `.list` manifest of zh and en lines over 24 kHz wavs. Both
packages' `run_prepare` run with their loaders patched to return small
models, the port's carried over from JAX's parameters by `weights.*_from_jax`
(the published model files are not in the repository, and the loaders
build the full widths). The experiment directories compare file for file:
`2-name2text.txt` and the 32 kHz wavs identical, the features within
FEATURE_RTOL, the semantic codes identical on the same SSL features."""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gpt_sovits_tpu import run as jrun
from gpt_sovits_tpu.models import bert as jbert
from gpt_sovits_tpu.models import eres2net as jer
from gpt_sovits_tpu.models import hubert as jhub
from gpt_sovits_tpu.models.vits import SynthesizerTrn as JSynth
from gpt_sovits_tpu.prepare import extract as jextract
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu.utils import loaders as jl
from gpt_sovits_tpu_torch import run as prun
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.dsp.audio_io import save_wav
from gpt_sovits_tpu_torch.models import bert as pbert
from gpt_sovits_tpu_torch.models import eres2net as per
from gpt_sovits_tpu_torch.models import hubert as phub
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.prepare import extract as pextract
from gpt_sovits_tpu_torch.utils import config as pconfig
from gpt_sovits_tpu_torch.utils import loaders as pl
from test_torch_bert import bert_params
from test_torch_encoders import HUBERT_TINY, random_params

torch.set_num_threads(2)

# f32 on both sides through a few layers, saved as float16: the features agree
# to float16's rounding (relative L2 of the arrays)
FEATURE_RTOL = 2e-3
SV_TINY = dict(num_blocks=(1, 1, 2, 1), m_channels=8, feat_dim=80, base_width=24, scale=4, expansion=4)
BERT_TINY = dict(vocab_size=chip_smoke.BERT_VOCAB, hidden_size=64, num_layers=3, num_heads=4, intermediate_size=96,
                 max_position_embeddings=128)
S2_TINY = dict(spec_channels=65, segment_size=8, inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2,
               n_layers=2, kernel_size=3, upsample_rates=(4, 4), upsample_initial_channel=32,
               upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
               gin_channels=16, mrte_hidden=16, ssl_dim=HUBERT_TINY["hidden_size"], n_codes=64, sv_dim=24)
LINES = [("zh", "今天是二零二四年三月五日，银行行长说你好好想想。"), ("en", "Hello there, this is a short test."),
         ("zh", "这是参考音频的文本，说得很清楚。"), ("en", "Numbers like 42 are read out as words.")]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The wavs, the manifest and both experiment directories; deleted when
    the module's tests end."""
    root = tmp_path_factory.mktemp("prepare")
    wavs = root / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i, (lang, text) in enumerate(LINES):
        sec = 1.4 + 0.2 * i
        t = np.arange(int(24000 * sec)) / 24000
        wav = 0.3 * np.sin(2 * np.pi * (120 + 30 * i) * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
        save_wav(str(wavs / f"utt{i}.wav"), (wav + 0.02 * rng.standard_normal(t.size)).astype(np.float32), 24000)
        lines.append(f"{wavs / f'utt{i}.wav'}|spk|{lang.upper()}|{text}\n")
    manifest = root / "corpus.list"
    manifest.write_text("".join(lines), encoding="utf-8")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(chip_smoke.bert_vocab()) + "\n", encoding="utf-8")
    yield root, str(manifest), str(vocab)
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def models():
    """Small JAX models and their parameters, and the port's on the same
    weights."""
    jb_cfg = jbert.BertConfig(**BERT_TINY)
    jb = (jbert.BertEncoder(jb_cfg), bert_params(jb_cfg, seed=1))
    pb = pbert.BertEncoder(pbert.BertConfig(**BERT_TINY))
    pb.load_state_dict(weights.bert_from_jax(jax.tree.map(np.asarray, jb[1]), pb.cfg))
    jh = jhub.HubertEncoder(jhub.HubertConfig(**HUBERT_TINY))
    jh_params = random_params(jh, jnp.zeros((1, 800)), seed=2)
    jh_params = jax.tree.map(lambda x: x * 0.5, jh_params)
    ph = phub.HubertEncoder(phub.HubertConfig(**HUBERT_TINY))
    ph.load_state_dict(weights.hubert_from_jax(jax.tree.map(np.asarray, jh_params), ph.cfg))
    js_cfg = jconfig.S2Config(version="v2", **S2_TINY)
    js = JSynth(js_cfg)
    js_params = random_params(js, jnp.zeros((1, 8, js_cfg.ssl_dim)), jnp.zeros((1, 10, 65)), jnp.asarray([10]),
                              jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]), method=JSynth.init_all, seed=3)
    ps = SynthesizerTrn(pconfig.S2Config(version="v2", **S2_TINY))
    ps.load_state_dict(weights.s2_from_jax(jax.tree.map(np.asarray, js_params), ps.cfg))
    jv_cfg = jer.ERes2NetConfig(**SV_TINY)
    jv = jer.ERes2NetV2(jv_cfg)
    jv_params = random_params(jv, jnp.zeros((1, 50, 80)), seed=4)
    pv = per.ERes2NetV2(per.ERes2NetConfig(**SV_TINY))
    pv.load_state_dict(weights.eres2net_from_jax(jax.tree.map(np.asarray, jv_params), pv.cfg))
    return {"jax": {"bert": jb, "hubert": (jh, jh_params), "s2": (js, js_params), "sv": (jv, jv_params)},
            "port": {"bert": pb.eval(), "hubert": ph.eval(), "s2": ps.eval(), "sv": pv.eval()}}


@pytest.fixture(scope="module")
def prepared(corpus, models):
    """Both packages' run_prepare on the same manifest, with all four models."""
    from transformers import BertTokenizer as HFTokenizer

    from gpt_sovits_tpu_torch.text.bert_tokenizer import BertTokenizer

    root, manifest, vocab = corpus
    j, p = models["jax"], models["port"]
    mp = pytest.MonkeyPatch()
    mp.setattr(jl, "load_bert", lambda path: (*j["bert"], HFTokenizer(vocab)))
    mp.setattr(jl, "load_hubert", lambda path: j["hubert"])
    mp.setattr(jl, "load_s2", lambda path, version=None: (*j["s2"], "v2"))
    mp.setattr(jl, "load_sv", lambda path: j["sv"])
    mp.setattr(pl, "load_bert", lambda path: (p["bert"], BertTokenizer(vocab)))
    mp.setattr(pl, "load_hubert", lambda path: p["hubert"])
    mp.setattr(pl, "load_s2", lambda path, version=None: (p["s2"], "v2"))
    mp.setattr(pl, "load_sv", lambda path: p["sv"])
    try:
        kw = dict(version="v2", bert="bert", hubert="hubert", s2="s2.pth", sv="sv.ckpt", log=lambda *a, **k: None)
        jrun.run_prepare(manifest, str(root / "exp_jax"), **kw)
        prun.run_prepare(manifest, str(root / "exp_port"), device="cpu", **kw)
    finally:
        mp.undo()
    return root / "exp_jax", root / "exp_port"


def _names():
    return [f"utt{i}.wav" for i in range(len(LINES))]


def test_text_stage_identical_and_bert_features(prepared):
    jexp, pexp = prepared
    text = (pexp / "2-name2text.txt").read_text(encoding="utf-8")
    assert text == (jexp / "2-name2text.txt").read_text(encoding="utf-8")
    assert len(text.splitlines()) == len(LINES)
    zh = [n for n, (lang, _) in zip(_names(), LINES) if lang == "zh"]
    assert sorted(p.name for p in (pexp / "3-bert").iterdir()) == sorted(f"{n}.npy" for n in zh)
    for n in zh:
        got, want = np.load(pexp / "3-bert" / f"{n}.npy"), np.load(jexp / "3-bert" / f"{n}.npy")
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
        assert rel(got, want) < FEATURE_RTOL, (n, rel(got, want))


def test_audio_sv_stages_and_semantic_codes(prepared):
    jexp, pexp = prepared
    for n in _names():
        assert (pexp / "5-wav32k" / n).read_bytes() == (jexp / "5-wav32k" / n).read_bytes(), n
        for sub in ("4-cnhubert", "7-sv_cn"):
            got, want = np.load(pexp / sub / f"{n}.npy"), np.load(jexp / sub / f"{n}.npy")
            assert got.dtype == want.dtype == np.float16 and got.shape == want.shape, (sub, n)
            assert rel(got, want) < FEATURE_RTOL, (sub, n, rel(got, want))
    rows = [ln.split("\t") for ln in (pexp / "6-name2semantic.tsv").read_text().splitlines()]
    jrows = [ln.split("\t") for ln in (jexp / "6-name2semantic.tsv").read_text().splitlines()]
    assert [r[0] for r in rows] == [r[0] for r in jrows] == _names()
    codes = np.concatenate([np.asarray(r[1].split(), int) for r in rows])
    jcodes = np.concatenate([np.asarray(r[1].split(), int) for r in jrows])
    assert codes.shape == jcodes.shape and (codes == jcodes).mean() >= 0.99  # from each side's own SSL features
    assert len(set(codes.tolist())) > 3


def test_semantic_stage_identical_on_the_same_features(prepared, corpus, models):
    """Both semantic stages on JAX's 4-cnhubert: the codes are identical."""
    jexp, _ = prepared
    root, manifest, _ = corpus
    same = root / "exp_same"
    shutil.copytree(jexp / "4-cnhubert", same / "4-cnhubert")
    model = models["port"]["s2"]
    with torch.no_grad():
        path = pextract.prepare_semantic(manifest, str(same),
                                         extract_latent_fn=lambda ssl: model.extract_latent(torch.from_numpy(ssl[None]))[0])
    pextract.merge_semantic_shards(str(same), 1)
    assert Path(path).name == "6-name2semantic-0.tsv" and not Path(path).exists()
    assert (same / "6-name2semantic.tsv").read_text() == (jexp / "6-name2semantic.tsv").read_text()


def test_check_details_and_manifest_equal_jax(prepared, corpus, tmp_path):
    jexp, pexp = prepared
    _, manifest, _ = corpus
    assert pextract.check_details(list_file=manifest, exp_dir=str(pexp)) == []
    assert pextract.read_manifest(manifest) == [pextract.ListItem(**vars(i)) for i in jextract.read_manifest(manifest)]
    bad = tmp_path / "bad.list"
    bad.write_text("a.wav|spk|zh\n", encoding="utf-8")
    cases = [dict(list_file=str(bad)), dict(list_file=str(tmp_path / "x.txt")), dict(list_file=str(tmp_path / "no.list")),
             dict(list_file=manifest, audio_dir=str(tmp_path / "nodir")), dict(exp_dir=str(tmp_path)),
             dict(list_file=manifest, exp_dir=str(pexp))]
    for kw in cases:
        assert pextract.check_details(**kw) == jextract.check_details(**kw), kw
    assert pextract.normalize_wav32k(np.zeros(4, np.float32)) is None
    x = np.asarray([0.1, -0.5, 0.3], np.float32)
    np.testing.assert_array_equal(pextract.normalize_wav32k(x), jextract.normalize_wav32k(x))
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_latest_step_model_equals_jax(tmp_path):
    names = ["s2G-e3.pth", "s2G-e12.pth", "x_e4_s400.pth", "y_e9_s90.pth", "model_step_250.pth", "ck_1000.pth",
             "notes.txt", "plain.pth"]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    for ext in (".pth", ".txt", ".ckpt"):
        assert prun.latest_step_model(str(tmp_path), ext) == jrun.latest_step_model(str(tmp_path), ext)
    assert prun.latest_step_model(str(tmp_path), ".pth").endswith("ck_1000.pth")
    assert prun.latest_step_model(str(tmp_path / "missing"), ".pth") == ""
    shutil.rmtree(tmp_path, ignore_errors=True)
