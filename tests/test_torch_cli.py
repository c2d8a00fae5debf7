"""The port's command line (gpt_sovits_tpu_torch/cli.py) on the CPU: the help
of every subcommand (every one of the JAX cli's is ported; `export` is
tested in test_torch_export.py); `slice`,
`list-models`, `denoise`, `separate` and `asr` (a stub funasr) against the
JAX package's cli; `download` without the network; the `webui` and
`serve-training` wiring; the `prepare` and `train-*`
wiring against JAX's, with the drivers patched to record their arguments;
`tts` and `serve` (`--device cpu`) on a tiny v2ProPlus pipeline that a
patched `build_pipeline` returns; TTSService's weight hook swapping S1
weights through `load_s1`."""

import json
import shutil
import struct
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from gpt_sovits_tpu import cli as jcli
from gpt_sovits_tpu import run as jrun
from gpt_sovits_tpu_torch import cli
from gpt_sovits_tpu_torch import run as prun
from gpt_sovits_tpu_torch.dsp.audio_io import save_wav
from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline
from gpt_sovits_tpu_torch.models.eres2net import ERes2NetConfig, ERes2NetV2
from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.serve import api
from gpt_sovits_tpu_torch.train import ckpt as ckpt_io
from gpt_sovits_tpu_torch.utils import config as pconfig
from gpt_sovits_tpu_torch.utils import loaders as pl
from test_torch_pipeline import HUB, INFER, MEL, S1, S2, SV

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SUBCOMMANDS = ("slice", "prepare", "train-s1", "train-s2", "train-v3", "tts", "serve", "list-models", "denoise",
               "separate", "asr", "webui", "serve-training", "download", "export")
NO_DEVICE = ("slice", "list-models", "asr", "webui", "download")  # the subcommands that run no model
NOT_PORTED = ()  # every subcommand of the JAX cli is ported
S1_CLI = dict(S1, max_len=4096)  # the serving pool's cache: tx 512 + prompt 512 + 750 new tokens
TEXT = "Hello world this is the first segment. And here comes the second one!"


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """The files a test writes are deleted when it ends, passed or failed."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def tiny_pipeline(seed: int = 0) -> TTSPipeline:
    torch.manual_seed(seed)
    return TTSPipeline(
        s1_model=T2SDecoder(pconfig.S1Config(**S1_CLI)), s2_model=SynthesizerTrn(pconfig.S2Config(**S2)),
        hubert_model=HubertEncoder(HubertConfig(**HUB)), sv_model=ERes2NetV2(ERes2NetConfig(**SV)),
        mel_cfg=pconfig.MelConfig(**MEL), infer_cfg=pconfig.InferenceConfig(**INFER, top_k=1), device="cpu")


@pytest.fixture
def ref_wav(tmp_path):
    """0.8 s at 8 kHz: the tiny HuBERT (x20 downsampling) makes ~370 prompt
    tokens of it, inside the serving pool's 512."""
    rng = np.random.default_rng(0)
    t = np.arange(int(0.8 * 8000)) / 8000.0
    wav = 0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.05 * rng.standard_normal(t.size)
    path = tmp_path / "ref.wav"
    save_wav(str(path), wav.astype(np.float32), 8000)
    return str(path)


@pytest.fixture
def built(monkeypatch):
    """build_pipeline patched to record its arguments and return a tiny
    pipeline."""
    calls = []

    def fake(**kw):
        calls.append(kw)
        assert kw["device"] == "cpu"
        return tiny_pipeline()

    monkeypatch.setattr(pl, "build_pipeline", fake)
    return calls


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_help_of_every_subcommand(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("usage:") and cmd in out
    assert ("--device" in out) == (cmd not in NO_DEVICE), cmd


def test_subcommands_not_ported_are_not_listed(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for cmd in SUBCOMMANDS:
        assert cmd in out
    for cmd in NOT_PORTED:
        with pytest.raises(SystemExit) as e:
            cli.main([cmd])
        assert e.value.code == 2
        assert f"invalid choice: '{cmd}'" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# slice, list-models
# ---------------------------------------------------------------------------


def test_slice_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(1)
    sr = 16000
    parts = []
    for sec, loud in ((1.2, True), (0.6, False), (2.0, True), (0.8, False), (1.5, True)):
        n = int(sec * sr)
        t = np.arange(n) / sr
        parts.append(0.3 * np.sin(2 * np.pi * 200 * t) if loud else 1e-4 * rng.standard_normal(n))
    path = tmp_path / "long.wav"
    save_wav(str(path), np.concatenate(parts).astype(np.float32), sr)
    args = [str(path), "--min-length", "1000", "--min-interval", "300"]
    cli.main(["slice", *args, "--out-dir", str(tmp_path / "port")])
    jcli.main(["slice", *args, "--out-dir", str(tmp_path / "jax")])
    port, jax_ = sorted((tmp_path / "port").iterdir()), sorted((tmp_path / "jax").iterdir())
    assert [p.name for p in port] == [p.name for p in jax_] and len(port) == 3
    for a, b in zip(port, jax_):
        assert a.read_bytes() == b.read_bytes(), a.name
    out = capsys.readouterr().out.splitlines()
    assert out == [f"wrote 3 slices to {tmp_path / d}" for d in ("port", "jax")]


def test_list_models_equals_jax(tmp_path, capsys):
    for d, names in (("GPT_weights_v2ProPlus", ["a-e5.ckpt", "a-e15.ckpt"]), ("SoVITS_weights_v2ProPlus", ["b_e8_s96.pth"]),
                     ("SoVITS_weights_v4", ["c_e2_s10.pth", "c_e4_s20.pth"]), ("GPT_weights", ["x.txt"])):
        (tmp_path / d).mkdir()
        for n in names:
            (tmp_path / d / n).write_bytes(b"")
    cli.main(["list-models", "--root", str(tmp_path)])
    jcli.main(["list-models", "--root", str(tmp_path)])
    port, jax_ = capsys.readouterr().out.split("\n}\n")[:2]
    assert json.loads(port + "}") == json.loads(jax_ + "}")
    assert json.loads(port + "}")["v4"]["sovits"].endswith("c_e4_s20.pth")


def test_runs_as_a_module(tmp_path):
    res = subprocess.run([sys.executable, "-m", "gpt_sovits_tpu_torch.cli", "list-models", "--root", str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and json.loads(res.stdout) == {}, res.stderr[-2000:]


# ---------------------------------------------------------------------------
# prepare and train-* wiring
# ---------------------------------------------------------------------------

WIRING = [
    ("run_prepare", ["prepare", "--list", "c.list", "--exp-dir", "exp", "--version", "v2ProPlus", "--bert", "b",
                     "--hubert", "h", "--s2", "s2.pth", "--sv", "sv.ckpt"]),
    ("run_train_s1", ["train-s1", "--exp-dir", "exp", "--ckpt-dir", "ck", "--batch-size", "4", "--epochs", "2",
                      "--save-every", "1", "--dpo", "--pretrained-s1", "s1.ckpt"]),
    ("run_train_s2", ["train-s2", "--exp-dir", "exp", "--ckpt-dir", "ck", "--version", "v2Pro", "--batch-size", "2",
                      "--pretrained-s2g", "g.pth", "--pretrained-s2d", "d.pth", "--dp"]),
    ("run_train_v3", ["train-v3", "--exp-dir", "exp", "--ckpt-dir", "ck", "--version", "v4", "--lora-rank", "16",
                      "--pretrained", "v4.pth"]),
]


@pytest.mark.parametrize("fn,argv", WIRING, ids=[w[0] for w in WIRING])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_driver_wiring_equals_jax(monkeypatch, fn, argv, device):
    calls = {}
    for mod, key in ((prun, "port"), (jrun, "jax")):
        monkeypatch.setattr(mod, fn, lambda *a, _k=key, **kw: calls.__setitem__(_k, (a, kw)))
    cli.main(argv + (["--device", device] if device else []))
    jcli.main(argv)
    (pa, pkw), (ja, jkw) = calls["port"], calls["jax"]
    assert pa == ja and pkw.pop("device") == device
    assert pkw == jkw


# ---------------------------------------------------------------------------
# tts, serve
# ---------------------------------------------------------------------------


def _wav_file(path) -> tuple[int, np.ndarray]:
    data = Path(path).read_bytes()
    assert data[:4] == b"RIFF" and data[8:16] == b"WAVEfmt "
    fmt, ch, sr, _, _, bits = struct.unpack("<HHIIHH", data[20:36])
    assert (fmt, ch, bits) == (1, 1, 16) and data[36:40] == b"data"
    return sr, np.frombuffer(data[44:], "<i2")


def test_tts_writes_the_pipelines_audio(built, ref_wav, tmp_path, capsys):
    out = tmp_path / "out.wav"
    argv = ["tts", "--text", TEXT, "--lang", "en", "--ref-audio", ref_wav, "--output", str(out), "--seed", "3",
            "--s1", "s1.ckpt", "--s2", "s2.pth", "--hubert", "hub", "--sv", "sv.ckpt", "--device", "cpu"]
    res = cli.main(argv)
    assert built == [dict(s1_path="s1.ckpt", s2_path="s2.pth", version=None, hubert_path="hub", bert_path=None,
                          sv_path="sv.ckpt", device="cpu")]
    sr, samples = _wav_file(out)
    assert sr == res["sr"] == MEL["sampling_rate"] and res["audio"].dtype == np.int16
    np.testing.assert_array_equal(samples, res["audio"])
    pipe = tiny_pipeline()
    pipe.set_ref_audio(ref_wav, ref_lang="auto")
    want = pipe.run(TEXT, "en", seed=3, cut_method="cut5")[1]
    np.testing.assert_array_equal(res["audio"], want)
    tokens = res["pipeline"].last_tokens
    hop = 2 * int(np.prod(S2["upsample_rates"]))
    gap = int(sr * res["pipeline"].cfg.fragment_interval)
    assert len(samples) == sum(n * hop for n in tokens.values()) + (len(tokens) - 1) * gap
    assert "wrote" in capsys.readouterr().out


def _post(url, payload) -> tuple[int, bytes]:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


def test_serve_continuous_answers(built, ref_wav, monkeypatch, capsys):
    """`serve --continuous` on the tiny pipeline: the service that
    make_service builds serves a POST /tts from the slot pool; cmd_serve
    starts the server and stops it on KeyboardInterrupt."""
    servers, answers = [], []
    real_serve = api.serve
    monkeypatch.setattr(api, "serve", lambda *a, **kw: servers.append(real_serve(*a, **kw)) or servers[-1])

    def forever():
        port = servers[-1].server_address[1]
        answers.append(_post(f"http://127.0.0.1:{port}/tts", {"text": TEXT, "text_lang": "en", "ref_audio_path": ref_wav,
                                                               "prompt_lang": "en", "seed": 1}))
        raise KeyboardInterrupt

    monkeypatch.setattr(cli, "_forever", forever)
    argv = ["serve", "--continuous", "--slots", "2", "--port", "0", "--s1-quant", "bf16", "--kv-quant", "bf16",
            "--device", "cpu"]
    svc = cli.make_service(cli.parser().parse_args(argv))
    try:
        assert svc.continuous is not None and svc.weight_loader is None
        assert svc.continuous._cb_kw["slots"] == 2 and svc.pipeline.device.type == "cpu"
    finally:
        svc.continuous.close()
    cli.main(argv)
    assert built[-1]["s1_weight_quant"] == "bf16" and built[-1]["s1_kv_quant"] == "bf16"
    (code, body), = answers
    assert code == 200 and body[:4] == b"RIFF" and len(body) > 44
    assert "serving on 127.0.0.1:" in capsys.readouterr().out


def test_weight_hook_swaps_s1_through_load_s1(tmp_path):
    """The JAX package's serve passes no weight loader, and neither does the
    port's; TTSService's hook still swaps weights through a callable built
    on load_s1."""
    pipe = tiny_pipeline(seed=1)
    torch.manual_seed(7)
    new = T2SDecoder(pconfig.S1Config(**S1_CLI)).state_dict()
    path = ckpt_io.save_reference_pth(new, str(tmp_path / "s1-e9.ckpt"))

    def loader(which, p):
        assert which == "gpt"
        pipe.s1.load_state_dict(pl.load_s1(p, pconfig.S1Config(**S1_CLI)).state_dict())

    svc = api.TTSService(pipe, weight_loader=loader)
    code, body, _ = svc.set_weights("gpt", path)
    assert code == 200, body
    for k, v in new.items():
        assert torch.equal(pipe.s1.state_dict()[k], v.half().float()), k
    code, _, _ = api.TTSService(pipe).set_weights("gpt", path)
    assert code == 400


# ---------------------------------------------------------------------------
# the corpus tools and the services
# ---------------------------------------------------------------------------


def _corpus_wavs(d: Path, stereo: bool = False) -> None:
    d.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        t = np.arange(12000) / 16000
        wav = (0.4 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        save_wav(str(d / f"u{i}.wav"), np.stack([wav, 0.7 * wav], axis=1) if stereo else wav, 16000)


def _same_files(a: Path, b: Path) -> None:
    fa, fb = sorted(p.name for p in a.iterdir()), sorted(p.name for p in b.iterdir())
    assert fa == fb and fa
    for n in fa:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_denoise_and_separate_equal_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("GSVT_FRCRN_CKPT", raising=False)
    _corpus_wavs(tmp_path / "in")
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        dev = ["--device", "cpu"] if name == "port" else []
        main(["denoise", "--in-dir", str(tmp_path / "in"), "--out-dir", str(tmp_path / name / "den"), *dev])
        main(["separate", "--in-dir", str(tmp_path / "in"), "--vocal-dir", str(tmp_path / name / "voc"),
              "--other-dir", str(tmp_path / name / "inst"), *dev])
    for sub in ("den", "voc", "inst"):
        _same_files(tmp_path / "port" / sub, tmp_path / "jax" / sub)
    out = capsys.readouterr().out.replace(str(tmp_path / "port"), "X").replace(str(tmp_path / "jax"), "X")
    half = out.splitlines()
    assert half[:2] == half[2:4] and half[0] == "denoised 2 files -> X/den"


def test_separate_routes_a_model_file_to_its_family_on_the_device(tmp_path, monkeypatch):
    from gpt_sovits_tpu_torch.corpus import roformer

    seen = []
    monkeypatch.setattr(roformer, "separate",
                        lambda wav, sr, path, config_path=None, device=None: seen.append((wav.shape, path, device))
                        or (wav, wav))
    _corpus_wavs(tmp_path / "in", stereo=True)
    cli.main(["separate", "--input", str(tmp_path / "in" / "u0.wav"), "--vocal-dir", str(tmp_path / "v"),
              "--other-dir", str(tmp_path / "o"), "--model", "x/model_bs_roformer_ep_1.ckpt"])
    assert seen == [((2, 12000), "x/model_bs_roformer_ep_1.ckpt", None)]  # None: the card
    assert (tmp_path / "v" / "vocal_u0.wav").exists() and (tmp_path / "o" / "instrument_u0.wav").exists()


def test_asr_with_a_stub_equals_jax(tmp_path, monkeypatch, capsys):
    import types

    fun = types.ModuleType("funasr")
    fun.AutoModel = type("M", (), {"__init__": lambda s, **kw: None,
                                   "generate": lambda s, input: [{"text": "said " + Path(input).stem}]})
    monkeypatch.setitem(sys.modules, "funasr", fun)
    _corpus_wavs(tmp_path / "in")
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        main(["asr", "--in-dir", str(tmp_path / "in"), "--output", str(tmp_path / f"{name}.list"), "--speaker", "spk"])
    assert (tmp_path / "port.list").read_text(encoding="utf-8") == (tmp_path / "jax.list").read_text(encoding="utf-8")
    assert (tmp_path / "port.list").read_text(encoding="utf-8").splitlines()[0].endswith("|spk|ZH|said u0")


@pytest.mark.parametrize("argv", [["--models", "--names", "s1", "hubert"], ["--models"], ["--g2pw"], ["--uvr5"],
                                  ["--frcrn"], []])
def test_download_without_the_network(tmp_path, monkeypatch, capsys, argv):
    """Every asset is there already: each flag returns its path and fetches
    nothing (urllib made to raise)."""
    from gpt_sovits_tpu_torch.utils import download as dl

    def refuse(*a, **k):
        raise AssertionError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    for rel in dl.PRETRAINED.values():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"x")
    (tmp_path / "G2PWModel_1.1").mkdir()
    (tmp_path / "uvr5_weights" / "uvr5_weights").mkdir(parents=True)
    (tmp_path / "speech_frcrn_ans_cirm_16k.bin").write_bytes(b"x")
    cli.main(["download", "--dest", str(tmp_path), *argv])
    out = capsys.readouterr().out
    if argv[:1] == ["--g2pw"]:
        assert out.splitlines()[-1] == str(tmp_path / "G2PWModel_1.1")
    if argv[:1] == ["--uvr5"]:
        assert out.splitlines()[-1] == str(tmp_path / "uvr5_weights" / "uvr5_weights")
    if argv[:1] == ["--frcrn"]:
        assert out.splitlines()[-1] == str(tmp_path / "speech_frcrn_ans_cirm_16k.bin")


def test_webui_and_serve_training_wiring(monkeypatch, tmp_path):
    from gpt_sovits_tpu_torch.serve import training_steps, webui

    served = {}

    class Srv:
        server_address = ("127.0.0.1", 1234)

        def shutdown(self):
            served["shutdown"] = True

    def forever():
        raise KeyboardInterrupt

    monkeypatch.setattr(webui, "serve_webui", lambda host, port: served.setdefault("webui", (host, port)) and Srv())
    monkeypatch.setattr(cli, "_forever", forever)
    cli.main(["webui", "--port", "0"])
    assert served == {"webui": ("127.0.0.1", 0), "shutdown": True}
    monkeypatch.setattr(training_steps, "main", lambda cfg: served.setdefault("cfg", cfg))
    monkeypatch.setenv("GSVT_S1_EPOCHS", "3")
    cli.main(["serve-training", "--root", str(tmp_path), "--port", "0", "--version", "v2ProPlus", "--sv-path", "sv",
              "--device", "cpu"])
    cfg = served["cfg"]
    assert (cfg.root, cfg.port, cfg.version, cfg.sv_path, cfg.device, cfg.s1_epochs) == \
        (str(tmp_path), 0, "v2ProPlus", "sv", "cpu", 3)
