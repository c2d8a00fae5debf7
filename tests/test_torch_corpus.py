"""The port's corpus tools and utilities against the JAX package's on the
CPU: the denoise dispatch (FRCRN with a checkpoint, the spectral gate
without one; FRCRN within 2e-5 of JAX's, the gate and HPSS equal to JAX's
within 1e-6), the UVR5 router's choice of family, the ASR adapters and the
modelscope denoiser through stub modules (as tests/test_corpus.py drives
JAX's), the manifest writer, the i18n maps and the download tables; a
download is skipped when its file is there, with urllib made to raise."""

import os
import shutil
import sys
import types
import urllib.request

import numpy as np
import pytest
import torch

from gpt_sovits_tpu.corpus import asr as jasr
from gpt_sovits_tpu.corpus import denoise as jden
from gpt_sovits_tpu.corpus import uvr5 as juvr
from gpt_sovits_tpu.models import frcrn as jf
from gpt_sovits_tpu.utils import download as jdl
from gpt_sovits_tpu.utils import i18n as ji18n
from gpt_sovits_tpu_torch.corpus import asr as pasr
from gpt_sovits_tpu_torch.corpus import denoise as pden
from gpt_sovits_tpu_torch.corpus import uvr5 as puvr
from gpt_sovits_tpu_torch.models import frcrn as pf
from gpt_sovits_tpu_torch.utils import download as pdl
from gpt_sovits_tpu_torch.utils import i18n as pi18n

TINY = dict(complexity=4, channels=(1, 1, 2), fsmn_hidden=8, fsmn_lorder=3)


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def noisy_tone(sr: int, sec: float = 1.0, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * sec)) / sr
    speech = np.where((t > 0.3) & (t < 0.8), 0.5 * np.sin(2 * np.pi * 220 * t), 0.0)
    return (speech + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def test_spectral_gate_and_hpss_equal_jax():
    wav = noisy_tone(16000)
    np.testing.assert_allclose(pden.spectral_gate(wav, 16000), jden.spectral_gate(wav, 16000), atol=1e-6)
    for a, b in zip(puvr.hpss_vocal_emphasis(wav, 16000), juvr.hpss_vocal_emphasis(wav, 16000)):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.fixture
def frcrn_file(tmp_path, monkeypatch):
    """A seeded tiny FRCRN as its pytorch_model.bin; both packages' loaders
    read it at the tiny config."""
    torch.manual_seed(0)
    m = pf.FRCRN(pf.FRCRNConfig(**TINY)).eval()
    path = tmp_path / "pytorch_model.bin"
    torch.save(m.state_dict(), path)
    jload, pload = jf.load_frcrn, pf.load_frcrn
    monkeypatch.setattr(jf, "load_frcrn", lambda p: jload(p, jf.FRCRNConfig(**TINY)))
    monkeypatch.setattr(pf, "load_frcrn", lambda p, device=None: pload(p, pf.FRCRNConfig(**TINY), device))
    monkeypatch.setattr(jden, "_FRCRN_CACHE", {})
    monkeypatch.setattr(pden, "_FRCRN_CACHE", {})
    return str(path)


@pytest.mark.parametrize("sr", [16000, 22050])
def test_denoise_runs_frcrn_with_a_checkpoint(frcrn_file, sr, monkeypatch):
    wav = noisy_tone(sr, 0.7, seed=1)
    want = jden.denoise(wav, sr, frcrn_file)
    got = pden.denoise(wav, sr, frcrn_file, device="cpu")
    assert got.shape == wav.shape
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert not np.allclose(got, pden.spectral_gate(wav, sr), atol=1e-3)
    monkeypatch.setenv("GSVT_FRCRN_CKPT", frcrn_file)  # found through the environment, as in JAX
    np.testing.assert_allclose(pden.denoise(wav, sr, device="cpu"), got, atol=0)


def test_denoise_without_a_checkpoint_is_the_spectral_gate(tmp_path, monkeypatch):
    monkeypatch.delenv("GSVT_FRCRN_CKPT", raising=False)
    wav = noisy_tone(16000, seed=2)
    np.testing.assert_allclose(pden.denoise(wav, 16000), jden.denoise(wav, 16000), atol=1e-6)
    np.testing.assert_allclose(pden.denoise(wav, 16000, str(tmp_path / "missing.bin")), pden.spectral_gate(wav, 16000))


ROUTES = [("auto", "model_bs_roformer_ep_317.ckpt", "roformer"), ("auto", "MelBandRoformer.ckpt", "roformer"),
          ("roformer", "x.pth", "roformer"), ("auto", "vocals.onnx", "mdx"), ("mdx", "m.bin", "mdx"),
          ("auto", "HP5_only_main_vocal.pth", "vr"), ("vr", "VR-DeEchoAggressive.pth", "vr"),
          ("auto", None, "hpss"), ("hpss", None, "hpss")]


@pytest.mark.parametrize("backend,name,family", ROUTES)
def test_router_picks_the_family_as_jax(backend, name, family, monkeypatch):
    import gpt_sovits_tpu.corpus.mdx as jmdx
    import gpt_sovits_tpu.corpus.roformer as jrof
    import gpt_sovits_tpu.corpus.vr as jvr
    import gpt_sovits_tpu_torch.corpus.mdx as pmdx
    import gpt_sovits_tpu_torch.corpus.roformer as prof
    import gpt_sovits_tpu_torch.corpus.vr as pvr

    seen = []
    for pkg, mods in (("jax", (jrof, jmdx, jvr)), ("port", (prof, pmdx, pvr))):
        for fam, mod in zip(("roformer", "mdx", "vr"), mods):
            monkeypatch.setattr(mod, "separate", lambda *a, _f=fam, _p=pkg, **kw: seen.append((_p, _f, kw)) or (a[0], a[0]))
    for pkg, fn in (("jax", juvr.separate_vocals), ("port", puvr.separate_vocals)):
        monkeypatch.setattr(sys.modules[fn.__module__], "hpss_vocal_emphasis",
                            lambda w, sr, _p=pkg: seen.append((_p, "hpss", {})) or (w, w))
    wav = np.zeros(800, np.float32)
    juvr.separate_vocals(wav, 8000, backend=backend, model_path=name)
    puvr.separate_vocals(wav, 8000, backend=backend, model_path=name, device="cpu")
    assert [s[:2] for s in seen] == [("jax", family), ("port", family)]
    if family != "hpss":
        assert seen[1][2]["device"] == "cpu"


def test_router_refuses_a_model_backend_without_a_file():
    for fn in (juvr.separate_vocals, puvr.separate_vocals):
        with pytest.raises(ValueError):
            fn(np.zeros(10, np.float32), 8000, backend="vr")


def _stub_asr(monkeypatch):
    calls = {"built": 0}

    class FakeModel:
        def __init__(self, **kw):
            calls["built"] += 1
            calls["kw"] = kw

        def generate(self, input):
            return [{"text": f"text for {os.path.basename(input)} | x\n"}]

    class Seg:
        def __init__(self, text):
            self.text = text

    class FakeWhisper:
        def __init__(self, size):
            calls["size"] = size

        def transcribe(self, path, language=None):
            return [Seg("hello "), Seg(f"{language}")], {"language": language}

    fun = types.ModuleType("funasr")
    fun.AutoModel = FakeModel
    fw = types.ModuleType("faster_whisper")
    fw.WhisperModel = FakeWhisper
    monkeypatch.setitem(sys.modules, "funasr", fun)
    monkeypatch.setitem(sys.modules, "faster_whisper", fw)
    return calls


def test_asr_adapters_through_stub_modules_equal_jax(monkeypatch, tmp_path):
    calls = _stub_asr(monkeypatch)
    paths = ["/a/x.wav", "/a/y.wav"]
    assert pasr.transcribe_funasr(paths, language="zh") == jasr.transcribe_funasr(paths, language="zh")
    assert calls["kw"]["vad_model"] == "fsmn-vad"
    assert pasr.transcribe_whisper(paths, language="en") == jasr.transcribe_whisper(paths, language="en")
    for lang in ("zh", "yue", "en", "ja"):
        n = calls["built"]
        tr, jtr = pasr.make_transcriber(lang), jasr.make_transcriber(lang)
        assert tr("/a/z1.wav") == jtr("/a/z1.wav") and tr("/a/z2.wav")
        assert calls["built"] - n == (2 if lang in ("zh", "yue") else 0)  # one model a transcriber
    d = tmp_path / "wavs"
    d.mkdir()
    for n in ("b.wav", "a.flac", "c.txt", "d.mp3"):
        (d / n).write_bytes(b"")
    for lang in ("zh", "en"):
        out_p, out_j = tmp_path / f"p_{lang}.list", tmp_path / f"j_{lang}.list"
        pasr.transcribe_dir(str(d), str(out_p), language=lang, speaker="spk")
        jasr.transcribe_dir(str(d), str(out_j), language=lang, speaker="spk")
        assert out_p.read_text(encoding="utf-8") == out_j.read_text(encoding="utf-8")
        assert len(out_p.read_text(encoding="utf-8").splitlines()) == 3


def test_asr_without_its_packages_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "funasr", None)
    monkeypatch.setitem(sys.modules, "faster_whisper", None)
    for fn in (lambda: pasr.transcribe_funasr(["/a.wav"]), lambda: pasr.transcribe_whisper(["/a.wav"]),
               lambda: pasr.make_transcriber("zh"), lambda: pasr.make_transcriber("en")):
        with pytest.raises(ImportError):
            fn()


def test_write_manifest_equals_jax(tmp_path):
    entries = [("/a/x.wav", "hello | world\n"), ("/a/y.wav", "  "), ("/a/z.wav", "second")]
    p = pasr.write_manifest(entries, str(tmp_path / "p" / "out.list"), speaker="spk", language="en")
    j = jasr.write_manifest(entries, str(tmp_path / "j" / "out.list"), speaker="spk", language="en")
    assert open(p, encoding="utf-8").read() == open(j, encoding="utf-8").read()


def test_modelscope_denoise_through_a_stub(monkeypatch, tmp_path):
    seen = {}

    def fake_pipeline(task, model):
        seen["task"], seen["model"] = task, model
        return lambda wav_path, output_path: open(output_path, "wb").write(b"RIFF")

    pk, pipes = types.ModuleType("modelscope"), types.ModuleType("modelscope.pipelines")
    pipes.pipeline = fake_pipeline
    pk.pipelines = pipes
    monkeypatch.setitem(sys.modules, "modelscope", pk)
    monkeypatch.setitem(sys.modules, "modelscope.pipelines", pipes)
    out = str(tmp_path / "den.wav")
    assert pden.denoise_modelscope("/a/in.wav", out) == out and os.path.exists(out)
    assert seen == {"task": "acoustic-noise-suppression", "model": "damo/speech_frcrn_ans_cirm_16k"}
    monkeypatch.setitem(sys.modules, "modelscope", None)
    monkeypatch.delitem(sys.modules, "modelscope.pipelines")
    with pytest.raises(ImportError):
        pden.denoise_modelscope("/a/in.wav", out)


@pytest.mark.parametrize("language", [None, "zh", "zh-CN", "zh_HK", "ja", "ko-KR", "en", "fr_FR", "pt-PT", "tr",
                                      "de_DE", "xx", ""])
def test_i18n_equals_jax(language, monkeypatch):
    monkeypatch.setenv("language", "ja_JP")
    assert pi18n.LOCALES == ji18n.LOCALES
    assert pi18n.resolve_language(language) == ji18n.resolve_language(language)
    p, j = pi18n.I18nAuto(language), ji18n.I18nAuto(language)
    assert p.mapping() == j.mapping() and p("Run") == j("Run") and p("not a key") == "not a key"


def test_download_tables_equal_jax():
    for name in ("HF_BASE", "PRETRAINED", "BIGVGAN_BASE", "G2PW_URL", "UVR5_URL", "FRCRN_URL", "ASR_MODELS"):
        assert getattr(pdl, name) == getattr(jdl, name), name


def test_downloads_are_skipped_when_the_files_are_there(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    for rel in pdl.PRETRAINED.values():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"x")
    got = pdl.download_all(str(tmp_path))
    assert got == {k: str(tmp_path / v) for k, v in pdl.PRETRAINED.items()}
    (tmp_path / "G2PWModel_1.1").mkdir()
    assert pdl.download_g2pw(str(tmp_path), progress=False) == str(tmp_path / "G2PWModel_1.1")
    assert os.path.islink(tmp_path / "G2PWModel")
    (tmp_path / "uvr" / "uvr5_weights").mkdir(parents=True)
    assert pdl.download_uvr5(str(tmp_path / "uvr"), progress=False) == str(tmp_path / "uvr" / "uvr5_weights")
    (tmp_path / "speech_frcrn_ans_cirm_16k.bin").write_bytes(b"x")
    assert pdl.download_frcrn(str(tmp_path), progress=False).endswith("speech_frcrn_ans_cirm_16k.bin")
    with pytest.raises(AssertionError, match="no network"):
        pdl.download("s1", str(tmp_path / "empty"), progress=False)


def test_hpss_of_a_stereo_input_is_jax_channel_by_channel():
    wav = np.stack([noisy_tone(16000, seed=5), 0.5 * noisy_tone(16000, seed=6)])
    v, o = puvr.hpss_vocal_emphasis(wav, 16000)
    assert v.shape == o.shape == wav.shape
    for c in range(2):
        jv, jo = juvr.hpss_vocal_emphasis(wav[c], 16000)
        np.testing.assert_allclose(v[c], jv, atol=1e-6)
        np.testing.assert_allclose(o[c], jo, atol=1e-6)
    with pytest.raises(ValueError):  # JAX's takes mono only (ROADMAP queue 3)
        juvr.hpss_vocal_emphasis(wav, 16000)


def test_stereo_wav_io_equals_jax(tmp_path):
    from gpt_sovits_tpu.dsp import audio_io as jio
    from gpt_sovits_tpu_torch.dsp import audio_io as pio

    x = (0.3 * np.random.default_rng(7).standard_normal((1000, 2))).astype(np.float32)
    pio.save_wav(str(tmp_path / "p.wav"), x, 22050)
    jio.save_wav(str(tmp_path / "j.wav"), x, 22050)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    for sr in (None, 16000):
        for mono in (True, False):
            got, gsr = pio.load_wav(str(tmp_path / "p.wav"), sr, mono=mono)
            want, wsr = jio.load_wav(str(tmp_path / "p.wav"), sr, mono=mono)
            assert gsr == wsr and got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-6)
