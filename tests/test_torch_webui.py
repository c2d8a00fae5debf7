"""The port's webui panel (gpt_sovits_tpu_torch/serve/webui.py) against the
JAX package's: both panels run side by side on the CPU and the same requests
must give the same status codes, JSON, pages and files. The page in each
locale (query and Accept-Language), label proofreading, the job runner, the
slice / denoise / separate (HPSS) / asr (stub funasr) / one_click jobs on
real files, the prepare / train / tts jobs' wiring with the drivers
patched to record their arguments (the port's with `device`), and the
port's FRCRN denoise job (`model`) against its own `denoise_frcrn`."""

import json
import os
import shutil
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gpt_sovits_tpu import run as jrun
from gpt_sovits_tpu.serve import webui as jweb
from gpt_sovits_tpu.utils import loaders as jloaders
from gpt_sovits_tpu_torch import run as prun
from gpt_sovits_tpu_torch.dsp.audio_io import save_wav
from gpt_sovits_tpu_torch.serve import webui as pweb
from gpt_sovits_tpu_torch.utils import loaders as ploaders

PKGS = {"jax": jweb, "port": pweb}


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def panels():
    srvs = {k: m.serve_webui(port=0) for k, m in PKGS.items()}
    yield {k: "http://%s:%d" % s.server_address for k, s in srvs.items()}
    for s in srvs.values():
        s.shutdown()
        s.server_close()


def req(base, path, method="GET", data=None, headers=None):
    r = urllib.request.Request(base + path, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def both(panels, path, method="GET", data=None, headers=None):
    out = {k: req(b, path, method, data, headers) for k, b in panels.items()}
    assert out["port"] == out["jax"], (path, out)
    return out["port"]


def run_job(base, tool, params, timeout=60):
    code, body = req(base, f"/api/run/{tool}", "POST", json.dumps(params).encode())
    assert code == 202, body
    jid = json.loads(body)["id"]
    for _ in range(timeout * 50):
        j = json.loads(req(base, f"/api/jobs/{jid}")[1])
        if j["state"] != "running":
            return j
        time.sleep(0.02)
    raise TimeoutError(jid)


def jobs_as_jax(panels, tool, params_of):
    """The job on both panels, each with its own paths; -> {pkg: job}."""
    out = {k: run_job(b, tool, params_of(k)) for k, b in panels.items()}
    for j in out.values():
        assert j["state"] == "done", j["error"]
    strip = lambda j, k: [ln.replace(f"/{k}/", "/X/") for ln in j["log"]]  # noqa: E731
    assert strip(out["port"], "port") == strip(out["jax"], "jax")
    return out


def same_dirs(a, b):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb and fa
    for f in fa:
        assert open(os.path.join(a, f), "rb").read() == open(os.path.join(b, f), "rb").read(), f


@pytest.mark.parametrize("lang,header", [("", None), ("?lang=zh", None), ("?lang=ja_JP", None), ("", "ko-KR,ko;q=0.9"),
                                         ("", "fr"), ("?lang=xx", None)])
def test_page_equals_jax(panels, lang, header):
    code, page = both(panels, "/" + lang, headers={"Accept-Language": header} if header else None)
    assert code == 200 and b"__I18N_JSON__" not in page and b"const tr" in page
    assert pweb._render_page(lang[6:] or None) == jweb._render_page(lang[6:] or None)


def test_routes_and_labels_equal_jax(panels, tmp_path):
    assert both(panels, "/api/nope")[0] == 404
    assert both(panels, "/api/run/nope", "POST", b"{}")[0] == 404
    assert both(panels, "/api/run/slice", "POST", b"{not json")[0] == 400
    assert both(panels, "/api/labels", "POST", b"{}")[0] == 400
    assert both(panels, "/api/labels?list=/nonexistent.list")[0] == 400
    assert both(panels, "/api/audio?path=/nonexistent.wav")[0] == 404
    assert both(panels, "/api/jobs/none")[0] == 404
    lists = {}
    for k in PKGS:
        lists[k] = tmp_path / f"{k}.list"
        lists[k].write_text("/a.wav|spk|ZH|你好\n/b.wav|spk|EN|hi there\n/c.wav|spk|EN|third\n", encoding="utf-8")
    for edit in ({"index": 1, "text": "hi | edited", "lang": "en"}, {"index": 0, "delete": True},
                 {"index": 99, "delete": True}, {"index": 0, "text": "only text"}):
        got = {k: req(b, "/api/labels", "POST", json.dumps({"list": str(lists[k]), **edit}).encode())
               for k, b in panels.items()}
        assert got["port"] == got["jax"], edit
    assert lists["port"].read_text(encoding="utf-8") == lists["jax"].read_text(encoding="utf-8")
    got = {k: req(b, f"/api/labels?list={lists[k]}") for k, b in panels.items()}
    assert got["port"] == got["jax"] and len(json.loads(got["port"][1])["labels"]) == 2
    wav = tmp_path / "x.wav"
    save_wav(str(wav), np.zeros(800, np.float32), 8000)
    assert both(panels, f"/api/audio?path={wav}") == (200, wav.read_bytes())
    for d in ("GPT_weights_v2ProPlus", "SoVITS_weights_v2ProPlus"):
        (tmp_path / d).mkdir()
    (tmp_path / "GPT_weights_v2ProPlus" / "a-e15.ckpt").write_bytes(b"")
    code, body = both(panels, f"/api/models?root={tmp_path}")
    assert code == 200 and json.loads(body)["v2ProPlus"]["gpt"].endswith("a-e15.ckpt")


def test_job_runner_equals_jax():
    logs = {}
    for k, mod in PKGS.items():
        r = mod.JobRunner()
        ok = r.start("fine", lambda log: log("a", 1, "b"))
        bad = r.start("boom", lambda log: (log("starting"), 1 / 0))
        for jid in (ok, bad):
            for _ in range(500):
                if r.get(jid)["state"] != "running":
                    break
                time.sleep(0.01)
        logs[k] = [(r.get(j)["state"], r.get(j)["error"], r.get(j)["log"]) for j in (ok, bad)]
        assert [j["name"] for j in r.list()] in (["boom", "fine"], ["fine", "boom"]) and "log" not in r.list()[0]
    assert logs["port"] == logs["jax"] == [("done", None, ["a 1 b"]),
                                           ("failed", "ZeroDivisionError: division by zero", ["starting"])]


def raw_audio(path, stereo=False):
    rng = np.random.default_rng(0)
    sr = 16000
    parts = [(rng.standard_normal(sr * 2) * 0.3), np.zeros(sr), (rng.standard_normal(sr * 2) * 0.3)]
    wav = np.concatenate(parts).astype(np.float32)
    save_wav(str(path), np.stack([wav, 0.5 * wav], axis=1) if stereo else wav, sr)


def test_data_jobs_equal_jax(panels, tmp_path, monkeypatch):
    fun = types.ModuleType("funasr")

    class FakeModel:
        def __init__(self, **kw):
            pass

        def generate(self, input):
            return [{"text": "words of " + os.path.basename(input)}]

    fun.AutoModel = FakeModel
    monkeypatch.setitem(sys.modules, "funasr", fun)
    raw_audio(tmp_path / "raw.wav")
    raw_audio(tmp_path / "stereo.wav", stereo=True)
    d = {k: tmp_path / k for k in PKGS}
    jobs_as_jax(panels, "slice", lambda k: {"input": str(tmp_path / "raw.wav"), "out_dir": str(d[k] / "sliced"),
                                           "min_length": "1000"})
    same_dirs(d["port"] / "sliced", d["jax"] / "sliced")
    jobs_as_jax(panels, "denoise", lambda k: {"in_dir": str(d[k] / "sliced"), "out_dir": str(d[k] / "den")})
    same_dirs(d["port"] / "den", d["jax"] / "den")
    jobs_as_jax(panels, "asr", lambda k: {"in_dir": str(d[k] / "den"), "output": str(d[k] / "files.list")})
    assert (d["port"] / "files.list").read_text().replace("/port/", "/") == \
        (d["jax"] / "files.list").read_text().replace("/jax/", "/")
    jobs_as_jax(panels, "separate", lambda k: {"input": str(tmp_path / "raw.wav"), "vocal_dir": str(d[k] / "voc"),
                                              "other_dir": str(d[k] / "inst")})
    same_dirs(d["port"] / "voc", d["jax"] / "voc")
    same_dirs(d["port"] / "inst", d["jax"] / "inst")
    # a stereo file: HPSS channel by channel in the port (JAX's HPSS takes mono only, ROADMAP queue 3)
    j = run_job(panels["jax"], "separate", {"input": str(tmp_path / "stereo.wav"), "vocal_dir": str(d["jax"] / "v2"),
                                            "other_dir": str(d["jax"] / "i2")})
    assert j["state"] == "failed" and "broadcast" in j["error"]
    j = run_job(panels["port"], "separate", {"input": str(tmp_path / "stereo.wav"), "vocal_dir": str(d["port"] / "v2"),
                                             "other_dir": str(d["port"] / "i2")})
    assert j["state"] == "done", j["error"]
    from gpt_sovits_tpu_torch.dsp.audio_io import load_wav

    got, sr = load_wav(str(d["port"] / "v2" / "vocal_stereo.wav"), mono=False)
    assert got.shape[1] == 2 and sr == 16000


WIRING = [
    ("prepare", "run_prepare", {"list": "c.list", "exp_dir": "exp", "version": "v2ProPlus", "bert": "b", "hubert": "h",
                                "s2": "s2.pth", "sv": "sv.ckpt"}),
    ("train_s1", "run_train_s1", {"exp_dir": "e", "ckpt_dir": "c", "batch_size": "4", "epochs": "2", "dpo": True}),
    ("train_s2", "run_train_s2", {"exp_dir": "e", "ckpt_dir": "c", "version": "v2Pro", "pretrained_s2g": "g.pth"}),
    ("train_v3", "run_train_v3", {"exp_dir": "e", "ckpt_dir": "c", "version": "v4", "lora_rank": "8"}),
]


@pytest.mark.parametrize("tool,fn,params", WIRING, ids=[w[0] for w in WIRING])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_driver_jobs_wiring_equals_jax(panels, monkeypatch, tool, fn, params, device):
    calls = {}
    for mod, key in ((jrun, "jax"), (prun, "port")):
        monkeypatch.setattr(mod, fn, lambda *a, _k=key, **kw: calls.__setitem__(_k, (a, kw)))
    run_job(panels["jax"], tool, params)
    run_job(panels["port"], tool, dict(params, device=device) if device else params)
    (pa, pkw), (ja, jkw) = calls["port"], calls["jax"]
    assert pa == ja and pkw.pop("device") == device
    pkw.pop("log"), jkw.pop("log")
    assert pkw == jkw


def test_tts_and_one_click_equal_jax(panels, monkeypatch, tmp_path):
    class Pipe:
        def set_ref_audio(self, path, ref_text=None, ref_lang="auto"):
            self.ref = (path, ref_text, ref_lang)

        def run(self, text, lang, seed=0, cut_method="cut5"):
            return 32000, (np.arange(3200) % 100 * (1 + seed)).astype(np.int16)

    built = {"jax": [], "port": []}
    monkeypatch.setattr(jloaders, "build_pipeline", lambda **kw: built["jax"].append(kw) or Pipe())
    monkeypatch.setattr(ploaders, "build_pipeline", lambda **kw: built["port"].append(kw) or Pipe())
    for d in ({}, {"device": "cpu"}):
        for k in PKGS:
            for tool in ("tts", "tts"):  # the second is served from the pipeline cache
                j = run_job(panels[k], tool, {"text": "hi", "ref_audio": str(tmp_path / "r.wav"), "s1": "a.ckpt",
                                              "output": str(tmp_path / f"{k}.wav"), "seed": "1",
                                              **(d if k == "port" else {})})
                assert j["state"] == "done" and j["log"][-1] == "AUDIO:" + str(tmp_path / f"{k}.wav")
        assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    assert [kw.pop("device") for kw in built["port"]] == [None, "cpu"]
    assert built["port"] == built["jax"] * 2

    prepared = {}
    for mod, key in ((jrun, "jax"), (prun, "port")):
        monkeypatch.setattr(mod, "run_prepare", lambda lst, exp, _k=key, **kw: prepared.__setitem__(_k, open(lst).read()))
    fun = types.ModuleType("funasr")
    fun.AutoModel = type("M", (), {"__init__": lambda s, **kw: None,
                                   "generate": lambda s, input: [{"text": "t " + os.path.basename(input)}]})
    monkeypatch.setitem(sys.modules, "funasr", fun)
    raw_audio(tmp_path / "raw.wav")
    jobs_as_jax(panels, "one_click", lambda k: {"input": str(tmp_path / "raw.wav"), "work_dir": str(tmp_path / k),
                                                "min_length": "1000", "denoise": True})
    assert prepared["port"].replace("/port/", "/") == prepared["jax"].replace("/jax/", "/") and prepared["port"]
    same_dirs(tmp_path / "port" / "denoised", tmp_path / "jax" / "denoised")


def test_frcrn_denoise_job_runs_the_model(panels, tmp_path):
    from gpt_sovits_tpu_torch.corpus.denoise import denoise_frcrn
    from gpt_sovits_tpu_torch.models import frcrn as pf

    torch.manual_seed(0)
    ckpt = tmp_path / "pytorch_model.bin"
    torch.save(pf.FRCRN().state_dict(), ckpt)  # the published config, from the seed
    (tmp_path / "in").mkdir()
    raw_audio(tmp_path / "in" / "a.wav")
    j = run_job(panels["port"], "denoise", {"in_dir": str(tmp_path / "in"), "out_dir": str(tmp_path / "out"),
                                            "model": str(ckpt), "device": "cpu"}, timeout=120)
    assert j["state"] == "done", j["error"]
    from gpt_sovits_tpu_torch.dsp.audio_io import load_wav

    wav, sr = load_wav(str(tmp_path / "in" / "a.wav"))
    want = np.clip(np.round(denoise_frcrn(wav, sr, str(ckpt), "cpu") * 32768.0), -32768, 32767) / 32768.0
    got, _ = load_wav(str(tmp_path / "out" / "a.wav"))
    np.testing.assert_allclose(got, want, atol=1.5 / 32768)
