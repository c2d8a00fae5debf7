"""The port's training REST service (gpt_sovits_tpu_torch/serve/
training_service.py, training_steps.py) against the JAX package's: both
services run side by side on the CPU with the same fake steps (which write
real artifacts), and the same sequence of HTTP requests must give the same
status codes, the same JSON (timestamps, job ids and the two roots aside)
and the same files: the lifecycle, audio processing, labels, the default
character, async inference, resume, crash clean-up, orphan reconciliation
and invalidation (as tests/test_training_service.py:354-455 drive JAX's),
then the production wiring of both packages' `build_training_steps`."""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gpt_sovits_tpu import run as jrun
from gpt_sovits_tpu.serve import training_service as jts
from gpt_sovits_tpu.serve import training_steps as jsteps
from gpt_sovits_tpu_torch import run as prun
from gpt_sovits_tpu_torch.dsp.audio_io import save_wav
from gpt_sovits_tpu_torch.serve import training_service as pts
from gpt_sovits_tpu_torch.serve import training_steps as psteps

PKGS = {"jax": jts, "port": pts}
TIMES = ("updated_at", "completed_at", "inputs_sig")  # clocks, and a digest of the files' mtimes


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def artifact_steps(mod, record: list, crash_in=None, block=None):
    """Fake steps that write real artifacts, optionally blocking or raising
    (tests/test_training_service.py's)."""

    def write(path, text):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)

    def prepare(manifest, exp_dir):
        record.append("prepare")
        if crash_in == "prepare":
            raise RuntimeError("boom in prepare")
        write(os.path.join(exp_dir, "2-name2text.txt"), "a\tphones\n")
        write(os.path.join(exp_dir, "6-name2semantic.tsv"), "a\t1 2 3\n")
        for sub in ("4-cnhubert", "5-wav32k"):
            write(os.path.join(exp_dir, sub, "a.bin"), "x")

    def train_s2(exp_dir, ckpt_dir):
        record.append("train_s2")
        if block is not None:
            block.wait(10)
        if crash_in == "train_s2":  # a crash mid-write: a partial artifact, then death
            write(os.path.join(ckpt_dir, "s2G-e1.pth"), "partial")
            raise RuntimeError("boom in train_s2")
        write(os.path.join(ckpt_dir, "s2G-e8.pth"), "weights")

    def train_s1(exp_dir, ckpt_dir):
        record.append("train_s1")
        write(os.path.join(ckpt_dir, "s1-e15.ckpt"), "weights")

    def synth(ckpt_dir, text, lang, ref):
        n = 1600 + 10 * len(text)
        return 16000, (np.arange(n) % 200 - 100).astype(np.int16)

    def asr(path):
        return "EN", "text of " + os.path.basename(path)

    return mod.TrainingSteps(prepare, train_s2, train_s1, synth, asr)


class Pair:
    """The JAX and the port service over sockets, each on its own root."""

    def __init__(self, tmp, asr=False, **step_kw):
        self.tmp, self.records, self.svcs, self.srvs, self.bases, self.roots = tmp, {}, {}, {}, {}, {}
        for name, mod in PKGS.items():
            self.records[name] = []
            steps = artifact_steps(mod, self.records[name], **step_kw)
            if not asr:
                steps.asr = None
            self.roots[name] = str(tmp / name / "chars")
            self.svcs[name] = mod.TrainingService(self.roots[name], steps)
            self.srvs[name] = mod.serve_training(self.svcs[name], port=0)
            host, port = self.srvs[name].server_address
            self.bases[name] = f"http://{host}:{port}"

    def close(self):
        for s in self.srvs.values():
            s.shutdown()
            s.server_close()

    def norm(self, obj, name):
        if isinstance(obj, dict):
            return {k: self.norm(v, name) for k, v in obj.items() if k not in TIMES}
        if isinstance(obj, list):
            return [self.norm(v, name) for v in obj]
        if isinstance(obj, str):
            return obj.replace(self.roots[name], "<root>")
        return obj

    def req(self, method, path, data=None, query=""):
        """Both services' answers, checked equal; -> (code, JSON or bytes)."""
        out = {}
        for name, base in self.bases.items():
            r = urllib.request.Request(base + path + query, data=data, method=method)
            try:
                with urllib.request.urlopen(r, timeout=60) as resp:
                    code, body, ctype = resp.status, resp.read(), resp.headers.get("Content-Type")
            except urllib.error.HTTPError as e:
                code, body, ctype = e.code, e.read(), e.headers.get("Content-Type")
            body = self.norm(json.loads(body), name) if ctype == "application/json" else body
            out[name] = (code, ctype, body)
        assert out["port"] == out["jax"], (method, path, out)
        return out["port"][0], out["port"][2]

    def post(self, path, obj=None, raw=None, query=""):
        return self.req("POST", path, raw if raw is not None else json.dumps(obj or {}).encode(), query)

    def wait(self, name, states=("trained", "failed", "interrupted"), timeout=60.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            sts = [s.training_status(name) for s in self.svcs.values()]
            if all(st.get("state") in states for st in sts):
                break
            time.sleep(0.02)
        for s in self.svcs.values():  # the worker sets its last state just before it returns
            job = s._jobs.get(name)
            if job is not None:
                job.join(10)
        return self.req("GET", f"/api/v1/characters/{name}/training/status")[1]

    def same_files(self):
        def tree(root, name):
            out = {}
            for d, _, files in os.walk(root):
                for f in files:
                    p = os.path.join(d, f)
                    data = open(p, "rb").read()
                    if f.endswith(".json"):
                        data = json.dumps(self.norm(json.loads(data), name), sort_keys=True).encode()
                    elif f.endswith(".list"):
                        data = data.replace(root.encode(), b"<root>")
                    out[os.path.relpath(p, root)] = data
            return out

        p, j = tree(self.roots["port"], "port"), tree(self.roots["jax"], "jax")
        assert p == j, sorted(set(p) ^ set(j)) or [k for k in p if p[k] != j[k]]
        return p


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def speech_wav(path, seconds=(5, 5), seed=0, sr=16000) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    for s in seconds:
        parts += [(rng.standard_normal(sr * s) * 0.3).astype(np.float32), np.zeros(sr, np.float32)]
    save_wav(str(path), np.concatenate(parts[:-1]), sr)
    return path.read_bytes()


def test_lifecycle_and_labels_equal_jax(pair, tmp_path):
    assert pair.post("/api/v1/characters", {"name": "alice"})[0] == 201
    assert pair.post("/api/v1/characters", {"name": "alice"})[0] == 409
    assert pair.post("/api/v1/characters", {"name": "bad name!"})[0] == 400
    assert pair.post("/api/v1/characters", {})[0] == 400
    assert pair.req("GET", "/api/v1/characters")[1]["characters"][0]["name"] == "alice"
    code, body = pair.post("/api/v1/characters/alice/audio", raw=speech_wav(tmp_path / "up.wav"), query="?filename=up.wav")
    assert code == 200 and body["slices"] == 2
    entries = [["up_0000.wav", "en", "hello there"], ["up_0001.wav", "en", "oops txet"]]
    assert pair.post("/api/v1/characters/alice/manifest", {"entries": entries})[0] == 200
    assert pair.post("/api/v1/inference", {"character": "alice", "text": "x"})[0] == 400  # not trained
    assert pair.post("/api/v1/characters/alice/training/start", raw=b"")[0] == 202
    assert pair.wait("alice")["state"] == "trained"
    assert pair.records["port"] == pair.records["jax"] == ["prepare", "train_s2", "train_s1"]
    code, wav = pair.post("/api/v1/inference", {"character": "alice", "text": "hi"})
    assert code == 200 and wav[:4] == b"RIFF"
    labels = pair.req("GET", "/api/v1/characters/alice/labels")[1]["labels"]
    assert [l["text"] for l in labels] == ["hello there", "oops txet"]
    assert pair.post("/api/v1/characters/alice/labels/1", {"text": "fixed | text", "lang": "zh"})[0] == 200
    assert len(pair.post("/api/v1/characters/alice/labels/0", {"delete": True})[1]["labels"]) == 1
    assert pair.post("/api/v1/characters/alice/labels/9", {})[0] == 404
    code, blob = pair.req("GET", "/api/v1/characters/alice/download/s1-e15.ckpt")
    assert code == 200 and blob == b"weights"
    assert pair.req("GET", "/api/v1/characters/alice/download/nothing.bin")[0] == 404
    pair.same_files()
    assert pair.req("DELETE", "/api/v1/characters/alice")[0] == 200
    assert pair.req("DELETE", "/api/v1/characters/alice")[0] == 404
    assert pair.req("GET", "/api/v1/characters/alice/training/status")[0] == 404
    assert pair.req("GET", "/api/v1/nothing")[0] == 404


def test_audio_processing_default_character_and_async_inference_equal_jax(tmp_path):
    pair = Pair(tmp_path, asr=True)
    try:
        pair.post("/api/v1/characters", {"name": "carol"})
        raw = speech_wav(tmp_path / "raw.wav", seconds=(1, 2), seed=1)
        pair.post("/api/v1/characters/carol/audio", raw=raw, query="?filename=raw.wav")
        for denoise in (False, True):  # without a checkpoint the denoise is the spectral gate in both
            code, body = pair.post("/api/v1/characters/carol/audio/process", {"denoise": denoise})
            assert code == 200 and body["slices"] >= 1
        assert pair.req("GET", "/api/v1/characters/carol/audio/status")[1]["audio_state"] == "processed"
        files = pair.req("GET", "/api/v1/characters/carol/audio/files")[1]
        assert files["raw"] == ["raw.wav"] and "files.list" in files["dataset"]
        assert pair.req("GET", "/api/v1/characters/carol/labels")[1]["labels"][0]["text"].startswith("text of")
        pair.same_files()
        assert pair.req("DELETE", "/api/v1/characters/carol/audio/files/raw.wav")[0] == 200
        assert pair.req("DELETE", "/api/v1/characters/carol/audio/files/raw.wav")[0] == 404
        assert pair.post("/api/v1/characters/carol/set_default", raw=b"")[0] == 200
        assert pair.post("/api/v1/characters/nobody/set_default", raw=b"")[0] == 404
        assert pair.req("GET", "/api/v1/default_character")[1] == {"name": "carol"}
        assert pair.post("/api/v1/characters/carol/training/check_status", raw=b"")[1]["valid"] is False
        assert pair.post("/api/v1/inference", {"character": "carol", "text": "x", "async": True})[0] == 400
        for s in pair.svcs.values():
            s.store.set_status("carol", state="trained")
        ids = {}
        for name, base in pair.bases.items():
            r = urllib.request.Request(base + "/api/v1/inference", method="POST",
                                       data=json.dumps({"character": "carol", "text": "hello", "async": True}).encode())
            with urllib.request.urlopen(r) as resp:
                assert resp.status == 202
                ids[name] = json.loads(resp.read())["inference_id"]
        got = {}
        for name, base in pair.bases.items():
            for _ in range(200):
                with urllib.request.urlopen(f"{base}/api/v1/inference/{ids[name]}") as resp:
                    st = json.loads(resp.read())
                if st["status"] != "running":
                    break
                time.sleep(0.02)
            assert st == {"status": "completed", "error": None}
            with urllib.request.urlopen(f"{base}/api/v1/inference/{ids[name]}/download") as resp:
                got[name] = resp.read()
        assert got["port"] == got["jax"] and got["port"][:4] == b"RIFF"
        assert pair.req("GET", "/api/v1/inference/0123456789ab")[0] == 404
        code, wav = pair.post("/api/v1/inference", {"text": "hi"})  # the default character
        assert code == 200 and wav[:4] == b"RIFF"
        assert pair.post("/api/v1/characters/carol/training/clean", raw=b"")[0] == 200
        assert pair.req("GET", "/api/v1/characters/carol/training/status")[1]["state"] == "created"
        pair.same_files()
    finally:
        pair.close()


def make_character(pair, tmp_path, name="a"):
    pair.post("/api/v1/characters", {"name": name})
    raw = speech_wav(tmp_path / f"{name}.wav", seconds=(3,))
    pair.post(f"/api/v1/characters/{name}/audio", raw=raw, query="?filename=up.wav")
    pair.post(f"/api/v1/characters/{name}/manifest", {"entries": [["up_0000.wav", "en", "hello"]]})


def test_resume_skips_completed_steps_as_jax(pair, tmp_path):
    make_character(pair, tmp_path)
    pair.post("/api/v1/characters/a/training/start", raw=b"")
    assert pair.wait("a")["state"] == "trained"
    chk = pair.post("/api/v1/characters/a/training/check_status", raw=b"")[1]
    assert chk["valid"] and set(chk["steps"].values()) == {"completed"}
    pair.post("/api/v1/characters/a/training/start", raw=b"")
    assert pair.wait("a")["state"] == "trained"
    assert pair.records["port"] == pair.records["jax"] == ["prepare", "train_s2", "train_s1"]
    pair.same_files()


def test_crash_mid_step_clean_up_and_resume_as_jax(tmp_path):
    pair = Pair(tmp_path, crash_in="train_s2")
    try:
        make_character(pair, tmp_path)
        pair.post("/api/v1/characters/a/training/start", raw=b"")
        st = pair.wait("a")
        assert st["state"] == "failed" and "train_s2" in st["error"]
        chk = pair.post("/api/v1/characters/a/training/check_status", raw=b"")[1]
        assert chk["steps"]["prepare"] == "completed" and chk["steps"]["train_s2"] == "partial" and not chk["valid"]
        for name, mod in PKGS.items():
            pair.records[name].clear()
            pair.svcs[name].steps = artifact_steps(mod, pair.records[name])
        pair.post("/api/v1/characters/a/training/start", raw=b"")
        assert pair.wait("a")["state"] == "trained"
        assert pair.records["port"] == pair.records["jax"] == ["train_s2", "train_s1"]
        files = pair.same_files()
        assert "a/ckpt/s2G-e8.pth" in files and "a/ckpt/s2G-e1.pth" not in files
    finally:
        pair.close()


def test_orphaned_training_state_reconciled_as_jax(pair, tmp_path):
    make_character(pair, tmp_path)
    for s in pair.svcs.values():
        s.store.set_status("a", state="training", step="train_s2")
    st = pair.req("GET", "/api/v1/characters/a/training/status")[1]
    assert st["state"] == "interrupted" and st["error"] == "training worker died mid-step"
    pair.post("/api/v1/characters/a/training/start", raw=b"")
    assert pair.wait("a")["state"] == "trained"


def test_a_second_start_while_running_is_refused_as_jax(tmp_path):
    block = threading.Event()
    pair = Pair(tmp_path, block=block)
    try:
        make_character(pair, tmp_path)
        assert pair.post("/api/v1/characters/a/training/start", raw=b"")[0] == 202
        assert pair.post("/api/v1/characters/a/training/start", raw=b"")[0] == 409
        assert pair.post("/api/v1/characters/zz/training/start", raw=b"")[0] == 404
        block.set()
        assert pair.wait("a")["state"] == "trained"
    finally:
        block.set()
        pair.close()


def test_invalidation_as_jax(pair, tmp_path):
    make_character(pair, tmp_path)
    pair.post("/api/v1/characters/a/training/start", raw=b"")
    assert pair.wait("a")["state"] == "trained"
    for s in pair.svcs.values():
        with open(os.path.join(s.store.path("a"), "dataset", "extra.wav"), "wb") as f:
            f.write(b"RIFF0000WAVE")
    chk = pair.post("/api/v1/characters/a/training/check_status", raw=b"")[1]
    assert set(chk["steps"].values()) == {"stale"} and not chk["valid"]
    assert chk["status"]["state"] == "outdated"
    pair.post("/api/v1/characters/a/training/start", raw=b"")
    assert pair.wait("a")["state"] == "trained"
    assert pair.records["port"] == ["prepare", "train_s2", "train_s1"] * 2
    pair.post("/api/v1/characters/a/audio", raw=speech_wav(tmp_path / "more.wav", seconds=(2,), seed=1),
              query="?filename=more.wav")
    assert pair.req("GET", "/api/v1/characters/a/training/status")[1]["state"] == "outdated"
    pair.same_files()


# ---------------------------------------------------------------------------
# production wiring (training_steps.py)
# ---------------------------------------------------------------------------


def test_service_config_reads_the_same_environment(monkeypatch):
    for k, v in (("GSVT_SERVICE_ROOT", "/tmp/chars"), ("GSVT_S2_EPOCHS", "3"), ("GSVT_VERSION", "v3"),
                 ("GSVT_ASR", "false"), ("GSVT_SERVICE_PORT", "9999"), ("GSVT_BERT", "b")):
        monkeypatch.setenv(k, v)
    p, j = psteps.ServiceConfig(), jsteps.ServiceConfig()
    jf = vars(j)
    assert {k: v for k, v in vars(p).items() if k in jf} == jf and p.device is None
    assert (p.is_cfm, p.is_pro) == (j.is_cfm, j.is_pro) == (True, False)


@pytest.mark.parametrize("version", ["v2", "v2ProPlus", "v3"])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_step_wiring_equals_jax(monkeypatch, tmp_path, version, device):
    calls = {"jax": [], "port": []}
    for mod, key in ((jrun, "jax"), (prun, "port")):
        for fn in ("run_prepare", "run_train_s2", "run_train_v3", "run_train_s1"):
            monkeypatch.setattr(mod, fn, lambda *a, _k=key, _f=fn, **kw: calls[_k].append((_f, a, kw)))
    kw = dict(version=version, pretrained_s2g="g.pth", pretrained_s2d="d.pth", pretrained_s1="s1.ckpt", s1_epochs=2,
              sv_path="sv.ckpt", lora_rank=4, asr_enabled=False)
    for steps in (jsteps.build_training_steps(jsteps.ServiceConfig(**kw)),
                  psteps.build_training_steps(psteps.ServiceConfig(**kw, device=device))):
        steps.prepare("m.list", str(tmp_path))
        steps.train_s2(str(tmp_path), str(tmp_path))
        steps.train_s1(str(tmp_path), str(tmp_path))
        assert steps.asr is None
    for (pf, pa, pkw), (jf, ja, jkw) in zip(calls["port"], calls["jax"]):
        if pf != "run_prepare":  # each trainer has its own state directory in the port (ROADMAP queue 3)
            ja = (ja[0], os.path.join(ja[1], ("s1" if pf == "run_train_s1" else "s2") + "_state"))
        assert (pf, pa) == (jf, ja) and pkw.pop("device") == device and pkw == jkw
    assert [c[0] for c in calls["port"]] == ["run_prepare", "run_train_v3" if version == "v3" else "run_train_s2",
                                             "run_train_s1"]


def test_synthesize_builds_one_pipeline_on_the_device(monkeypatch, tmp_path):
    from gpt_sovits_tpu_torch.utils import loaders

    built = []

    class Pipe:
        def set_ref_audio(self, path, ref_text=None):
            self.ref = (path, ref_text)

        def run(self, text, lang):
            return 32000, np.zeros(10, np.int16)

    monkeypatch.setattr(loaders, "build_pipeline", lambda **kw: built.append(kw) or Pipe())
    steps = psteps.build_training_steps(psteps.ServiceConfig(version="v2ProPlus", sv_path="sv", device="cpu",
                                                             asr_enabled=False))
    with pytest.raises(RuntimeError, match="no trained weights"):
        steps.synthesize(str(tmp_path), "hi", "en", str(tmp_path / "ref.wav"))
    ck, ds = tmp_path / "ckpt", tmp_path / "dataset"
    ck.mkdir()
    ds.mkdir()
    for n in ("s1-e5.ckpt", "s1-e15.ckpt", "s2G-e8.pth"):
        (ck / n).write_bytes(b"")
    (ds / "files.list").write_text(f"{ds}/a_0000.wav|spk|EN|hello there\n", encoding="utf-8")
    for _ in range(2):
        assert steps.synthesize(str(ck), "hi", "en", str(ds / "a_0000.wav"))[0] == 32000
    assert len(built) == 1 and built[0]["device"] == "cpu" and built[0]["sv_path"] == "sv"
    assert built[0]["s1_path"].endswith("s1-e15.ckpt")
    assert psteps._manifest_text_for(str(ds / "a_0000.wav")) == jsteps._manifest_text_for(str(ds / "a_0000.wav"))


def test_make_asr_without_a_backend_is_none_as_jax(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "funasr", None)
    assert psteps._make_asr(psteps.ServiceConfig(asr_enabled=True)) is None
    assert jsteps._make_asr(jsteps.ServiceConfig(asr_enabled=True)) is None


def test_trainers_keep_their_states_apart_and_publish_their_weights(monkeypatch, tmp_path):
    """S2 and S1 both save `state_{step}`: each gets its own directory under
    ckpt/ (JAX's wiring shares one, and its S1 would resume from S2's
    state), and their exported weights are moved up into ckpt/, where the
    service's artifact check and `synthesize` look."""
    seen = {}

    def trainer(name, export):
        def run(exp_dir, work, **kw):
            seen[name] = sorted(os.listdir(work)) if os.path.isdir(work) else []
            os.makedirs(work, exist_ok=True)
            open(os.path.join(work, "state_2"), "w").write(name)
            path = os.path.join(work, export)
            open(path, "w").write(name)
            return {"exports": [path]}
        return run

    monkeypatch.setattr(prun, "run_train_s2", trainer("s2", "s2G-e1.pth"))
    monkeypatch.setattr(prun, "run_train_s1", trainer("s1", "s1-e1.ckpt"))
    steps = psteps.build_training_steps(psteps.ServiceConfig(version="v2ProPlus", asr_enabled=False))
    ck = tmp_path / "ckpt"
    ck.mkdir()
    steps.train_s2(str(tmp_path / "exp"), str(ck))
    steps.train_s1(str(tmp_path / "exp"), str(ck))
    assert seen == {"s2": [], "s1": []}  # S1 found no state of S2's to resume from
    assert sorted(os.listdir(ck)) == ["s1-e1.ckpt", "s1_state", "s2G-e1.pth", "s2_state"]
    assert open(ck / "s1_state" / "state_2").read() == "s1" and open(ck / "s2_state" / "state_2").read() == "s2"
    steps2 = artifact_steps(pts, [])
    svc = pts.TrainingService(str(tmp_path / "chars"), steps2)
    svc.store.create("a")
    shutil.copytree(ck, os.path.join(svc.store.path("a"), "ckpt"), dirs_exist_ok=True)
    assert svc._step_artifacts_ok("a", "train_s2") and svc._step_artifacts_ok("a", "train_s1")
    svc._clean_step_artifacts("a", "train_s2")  # a step's clean-up takes its state with it
    assert sorted(os.listdir(os.path.join(svc.store.path("a"), "ckpt"))) == ["s1-e1.ckpt", "s1_state"]
