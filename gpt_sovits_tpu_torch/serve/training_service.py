"""Character-based voice-clone training REST service (port of
gpt_sovits_tpu/serve/training_service.py; standard-library HTTP).

Re-design of the reference fork's server/ (training_service.py:1750,
training_steps.py): character CRUD, audio upload -> slice -> dataset,
background training orchestration (prepare -> S2 -> S1), filesystem-backed
status, and inference against a trained character. The reference launches
each step as a subprocess with env-var config; here steps are plain callables
run on a worker thread in the single controller process.

Filesystem layout per character (mirrors the reference's per-character
data dirs):
  {root}/{name}/raw/            uploaded originals
  {root}/{name}/dataset/        sliced wavs + files.list manifest
  {root}/{name}/exp/            prepare artifacts (2-name2text.txt, ...)
  {root}/{name}/ckpt/           training outputs
  {root}/{name}/status.json     {state, step, progress, error}
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import urllib.parse
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

_NAME_RE = re.compile(r"^[\w\-]{1,64}$")

TRAIN_STEPS = ("prepare", "train_s2", "train_s1")


@dataclass
class TrainingSteps:
    """Injectable step implementations (tests use fakes; production wires
    prepare/extract + train/s2_train + train/s1_train)."""

    prepare: Callable[[str, str], None]  # (manifest, exp_dir)
    train_s2: Callable[[str, str], None]  # (exp_dir, ckpt_dir)
    train_s1: Callable[[str, str], None]
    synthesize: Optional[Callable[..., tuple[int, np.ndarray]]] = None  # (ckpt_dir, text, lang, ref)
    asr: Optional[Callable[[str], tuple[str, str]]] = None  # wav path -> (lang, text)


class CharacterStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, name: str) -> str:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid character name {name!r}")
        return os.path.join(self.root, name)

    def list(self) -> list[dict]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if os.path.isdir(os.path.join(self.root, name)):
                out.append({"name": name, **self.status(name)})
        return out

    def create(self, name: str) -> None:
        p = self.path(name)
        if os.path.exists(p):
            raise FileExistsError(name)
        for sub in ("raw", "dataset", "exp", "ckpt"):
            os.makedirs(os.path.join(p, sub))
        self.set_status(name, state="created", step=None, progress=0.0)

    def delete(self, name: str) -> None:
        p = self.path(name)
        if not os.path.isdir(p):
            raise FileNotFoundError(name)
        shutil.rmtree(p)

    def exists(self, name: str) -> bool:
        return os.path.isdir(self.path(name))

    def status(self, name: str) -> dict:
        sp = os.path.join(self.path(name), "status.json")
        if not os.path.exists(sp):
            return {"state": "unknown"}
        with open(sp) as f:
            return json.load(f)

    def set_status(self, name: str, **kw) -> None:
        sp = os.path.join(self.path(name), "status.json")
        cur = self.status(name) if os.path.exists(sp) else {}
        cur.update(kw, updated_at=time.time())
        tmp = sp + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cur, f)
        os.replace(tmp, sp)  # atomic, like the reference's my_save move

    def add_audio(self, name: str, filename: str, data: bytes, *, slice_audio: bool = True) -> int:
        """Store an upload and slice it into dataset/ wavs. Returns #slices."""
        from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, save_wav
        from gpt_sovits_tpu_torch.dsp.slicer import Slicer

        p = self.path(name)
        raw_path = os.path.join(p, "raw", os.path.basename(filename))
        with open(raw_path, "wb") as f:
            f.write(data)
        if not slice_audio:
            return 0
        wav, sr = load_wav(raw_path)
        chunks = Slicer(sr, threshold=-34.0, min_length=4000, min_interval=300, hop_size=10, max_sil_kept=500).slice(wav)
        base = os.path.splitext(os.path.basename(filename))[0]
        ds = os.path.join(p, "dataset")
        for i, c in enumerate(chunks):
            save_wav(os.path.join(ds, f"{base}_{i:04d}.wav"), c, sr)
        return len(chunks)

    def write_manifest(self, name: str, entries: list[tuple[str, str, str]]) -> str:
        """entries: (wav_filename, lang, text). Returns manifest path."""
        p = self.path(name)
        manifest = os.path.join(p, "dataset", "files.list")
        with open(manifest, "w", encoding="utf-8") as f:
            for wav, lang, text in entries:
                f.write(f"{os.path.join(p, 'dataset', wav)}|{name}|{lang}|{text}\n")
        return manifest

    # -- label editing (the reference's subfix_webui dataset proofreading) --

    def read_labels(self, name: str) -> list[dict]:
        manifest = os.path.join(self.path(name), "dataset", "files.list")
        if not os.path.exists(manifest):
            return []
        out = []
        with open(manifest, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|", 3)
                if len(parts) == 4:
                    out.append({"path": parts[0], "speaker": parts[1], "lang": parts[2], "text": parts[3]})
        return out

    def update_label(self, name: str, index: int, *, text: str | None = None, lang: str | None = None, delete: bool = False) -> list[dict]:
        labels = self.read_labels(name)
        if not (0 <= index < len(labels)):
            raise IndexError(index)
        if delete:
            labels.pop(index)
        else:
            if text is not None:
                labels[index]["text"] = text.replace("|", " ")
            if lang is not None:
                labels[index]["lang"] = lang
        manifest = os.path.join(self.path(name), "dataset", "files.list")
        with open(manifest, "w", encoding="utf-8") as f:
            for l in labels:
                f.write(f"{l['path']}|{l['speaker']}|{l['lang']}|{l['text']}\n")
        return labels


class TrainingService:
    def __init__(self, root: str, steps: TrainingSteps, device=None):
        self.store = CharacterStore(root)
        self.steps = steps
        self.device = device  # where process_audio's FRCRN runs (the card unless "cpu")
        self._jobs: dict[str, threading.Thread] = {}
        self._lock = threading.Lock()
        self._inference_jobs: dict[str, dict] = {}  # id -> {status, sr, audio, error}

    # -- default character (ref /set_default, /default_character) ----------

    def set_default(self, name: str) -> None:
        if not self.store.exists(name):
            raise FileNotFoundError(name)
        with open(os.path.join(self.store.root, "default_character.json"), "w") as f:
            json.dump({"name": name}, f)

    def get_default(self) -> str | None:
        p = os.path.join(self.store.root, "default_character.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f).get("name")

    # -- audio processing (ref /audio/process: convert->slice[->denoise->asr])

    def process_audio(self, name: str, *, denoise: bool = False) -> dict:
        """(Re)slice every uploaded raw file into dataset/; optional spectral
        denoise; when an asr_fn step is configured, transcribe slices into
        the manifest (the reference chains slice -> denoise -> ASR)."""
        from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, save_wav
        from gpt_sovits_tpu_torch.dsp.slicer import Slicer

        p = self.store.path(name)
        raw_dir, ds = os.path.join(p, "raw"), os.path.join(p, "dataset")
        self.invalidate(name, "audio reprocessed")  # dataset is about to change
        self.store.set_status(name, audio_state="processing")
        n_slices = 0
        try:
            for fn in sorted(os.listdir(raw_dir)):
                wav, sr = load_wav(os.path.join(raw_dir, fn))
                if denoise:
                    from gpt_sovits_tpu_torch.corpus.denoise import denoise as _denoise

                    wav = _denoise(wav, sr, device=self.device)
                chunks = Slicer(sr, threshold=-34.0, min_length=4000, min_interval=300, hop_size=10, max_sil_kept=500).slice(wav)
                base = os.path.splitext(fn)[0]
                for i, c in enumerate(chunks):
                    save_wav(os.path.join(ds, f"{base}_{i:04d}.wav"), c, sr)
                n_slices += len(chunks)
            if self.steps.asr is not None:
                entries = []
                for fn in sorted(f for f in os.listdir(ds) if f.endswith(".wav")):
                    lang, text = self.steps.asr(os.path.join(ds, fn))
                    entries.append((fn, lang, text))
                self.store.write_manifest(name, entries)
            self.store.set_status(name, audio_state="processed", slices=n_slices)
        except Exception as e:
            self.store.set_status(name, audio_state="failed", error=str(e))
            raise
        return {"slices": n_slices}

    # -- artifact validation / cleanup (ref check_training_status_from_files,
    #    /training/clean, _clean_training_artifacts, invalidate_processing_status)

    def _dataset_signature(self, name: str) -> str:
        """Content signature of the training inputs (manifest + dataset
        wavs: names, sizes, mtimes). A change invalidates downstream step
        artifacts — the reference's invalidate_processing_status
        (training_service.py:855-885) driven by data instead of events."""
        import hashlib

        ds = os.path.join(self.store.path(name), "dataset")
        h = hashlib.sha1()
        if os.path.isdir(ds):
            for fn in sorted(os.listdir(ds)):
                st = os.stat(os.path.join(ds, fn))
                h.update(f"{fn}:{st.st_size}:{st.st_mtime_ns}".encode())
        return h.hexdigest()

    def _ledger_path(self, name: str) -> str:
        return os.path.join(self.store.path(name), "exp", "steps.json")

    def _read_ledger(self, name: str) -> dict:
        try:
            with open(self._ledger_path(name), encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _mark_step_done(self, name: str, step: str, sig: str) -> None:
        ledger = self._read_ledger(name)
        ledger[step] = {"completed_at": time.time(), "inputs_sig": sig}
        path = self._ledger_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"  # atomic like the reference's my_save (tmp+move)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(ledger, f)
        os.replace(tmp, path)

    def _step_artifacts_ok(self, name: str, step: str) -> bool:
        """Are the step's on-disk outputs present and non-empty?"""
        p = self.store.path(name)
        exp, ckpt = os.path.join(p, "exp"), os.path.join(p, "ckpt")

        def _nonempty(path):
            try:
                return os.path.getsize(path) > 0
            except OSError:
                return False

        def _any(d, prefix, exts):
            if not os.path.isdir(d):
                return False
            return any(
                f.startswith(prefix) and f.endswith(exts) and _nonempty(os.path.join(d, f))
                for f in os.listdir(d)
            )

        if step == "prepare":
            return _nonempty(os.path.join(exp, "2-name2text.txt")) and _nonempty(
                os.path.join(exp, "6-name2semantic.tsv")
            )
        if step == "train_s2":  # run.py:283-292 writes s2G-e*.npz/.pth
            return _any(ckpt, "s2", (".pth", ".npz"))
        if step == "train_s1":  # run.py:201-209 writes s1-e*.npz/.ckpt
            return _any(ckpt, "s1", (".ckpt", ".npz"))
        return False

    def step_states(self, name: str) -> dict:
        """Per-step artifact state: completed / stale (inputs changed since
        the step ran) / partial (artifacts without a ledger entry — e.g. a
        crash mid-write) / pending."""
        sig = self._dataset_signature(name)
        ledger = self._read_ledger(name)
        out = {}
        for step in TRAIN_STEPS:
            arts = self._step_artifacts_ok(name, step)
            entry = ledger.get(step)
            if entry and arts:
                out[step] = "completed" if entry.get("inputs_sig") == sig else "stale"
            elif arts or entry:
                out[step] = "partial"
            else:
                out[step] = "pending"
        return out

    def _clean_step_artifacts(self, name: str, step: str) -> None:
        """Selectively remove one step's outputs before re-running it
        (reference _clean_training_artifacts, training_service.py:887)."""
        p = self.store.path(name)
        exp, ckpt = os.path.join(p, "exp"), os.path.join(p, "ckpt")
        if step == "prepare":
            if os.path.isdir(exp):
                for fn in list(os.listdir(exp)):
                    if fn != "steps.json":
                        fp = os.path.join(exp, fn)
                        shutil.rmtree(fp) if os.path.isdir(fp) else os.remove(fp)
        elif step in ("train_s2", "train_s1"):
            prefix = "s2" if step == "train_s2" else "s1"
            if os.path.isdir(ckpt):
                for fn in list(os.listdir(ckpt)):
                    if fn.startswith(prefix):
                        fp = os.path.join(ckpt, fn)
                        shutil.rmtree(fp) if os.path.isdir(fp) else os.remove(fp)
        ledger = self._read_ledger(name)
        if ledger.pop(step, None) is not None:
            tmp = self._ledger_path(name) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(ledger, f)
            os.replace(tmp, self._ledger_path(name))

    def _reconcile_orphaned(self, name: str) -> dict:
        """status.json says "training" but no live worker thread — the
        process (or thread) died mid-step. Mark interrupted so the state
        machine can't wedge (reference relies on filesystem checks for the
        same reason: in-memory state dies with the process)."""
        st = self.store.status(name)
        if st.get("state") == "training":
            job = self._jobs.get(name)
            if job is None or not job.is_alive():
                self.store.set_status(name, state="interrupted", error="training worker died mid-step")
                st = self.store.status(name)
        return st

    def invalidate(self, name: str, reason: str) -> None:
        """Audio/dataset changed: a previously-trained character's model no
        longer reflects its data (reference invalidate_processing_status)."""
        st = self.store.status(name)
        if st.get("state") in ("trained", "interrupted"):
            self.store.set_status(name, state="outdated", error=None, reason=reason)

    def check_training_status(self, name: str) -> dict:
        """Validate on-disk artifacts and reconcile status.json, like the
        reference's filesystem-based check (training_service.py:754)."""
        from gpt_sovits_tpu_torch.prepare.extract import check_details

        p = self.store.path(name)
        st = self._reconcile_orphaned(name)
        problems = check_details(exp_dir=os.path.join(p, "exp"))
        ckpt_dir = os.path.join(p, "ckpt")
        has_ckpt = os.path.isdir(ckpt_dir) and any(os.scandir(ckpt_dir))
        steps = self.step_states(name)
        stale = [s for s, v in steps.items() if v == "stale"]
        bad = [s for s, v in steps.items() if v in ("stale", "partial")]
        all_problems = (
            problems
            + ([] if has_ckpt else ["no checkpoints"])
            + [f"{steps[s]} step: {s}" for s in bad]
        )
        ok = not all_problems
        if ok and st.get("state") not in ("trained", "training"):
            self.store.set_status(name, state="trained")
        elif not ok and st.get("state") == "trained":
            self.store.set_status(
                name, state="outdated" if stale else "invalid", problems=all_problems
            )
        return {
            "valid": ok,
            "problems": all_problems,
            "steps": steps,
            "status": self.store.status(name),
        }

    def clean_training(self, name: str) -> None:
        import shutil

        p = self.store.path(name)
        for sub in ("exp", "ckpt"):
            d = os.path.join(p, sub)
            if os.path.isdir(d):
                shutil.rmtree(d)
            os.makedirs(d, exist_ok=True)
        self.store.set_status(name, state="created", step=None, progress=0.0, error=None)

    # -- async inference jobs (ref POST /inference -> id; GET /{id}) --------

    def start_inference(self, name: str, text: str, lang: str = "auto") -> str:
        import uuid

        job_id = uuid.uuid4().hex[:12]
        self._inference_jobs[job_id] = {"status": "running", "character": name}

        def run():
            try:
                sr, audio = self.infer(name, text, lang)
                self._inference_jobs[job_id].update(status="completed", sr=sr, audio=audio)
            except Exception as e:
                self._inference_jobs[job_id].update(status="failed", error=str(e))

        threading.Thread(target=run, daemon=True).start()
        return job_id

    def inference_job(self, job_id: str) -> dict | None:
        return self._inference_jobs.get(job_id)

    # -- training orchestration (ref training_steps.StepProcessor) ---------

    def start_training(self, name: str, *, resume: bool = True) -> None:
        """Kick off (or resume) the prepare -> S2 -> S1 chain.

        resume=True (default): completed steps whose inputs are unchanged
        are skipped; a step left partial by a crash is cleaned and re-run
        (reference crash story: check_training_status_from_files +
        _clean_training_artifacts, training_service.py:754,887)."""
        if not self.store.exists(name):
            raise FileNotFoundError(name)
        with self._lock:
            job = self._jobs.get(name)
            if job is not None and job.is_alive():
                raise RuntimeError(f"training already running for {name}")
            # status flips synchronously so a poll right after start never
            # reads the previous terminal state
            self.store.set_status(name, state="training", step=None, progress=0.0, error=None)
            t = threading.Thread(target=self._run_training, args=(name, resume), daemon=True)
            self._jobs[name] = t
            t.start()

    def _run_training(self, name: str, resume: bool = True) -> None:
        p = self.store.path(name)
        manifest = os.path.join(p, "dataset", "files.list")
        exp_dir = os.path.join(p, "exp")
        ckpt_dir = os.path.join(p, "ckpt")
        plan = [
            ("prepare", lambda: self.steps.prepare(manifest, exp_dir)),
            ("train_s2", lambda: self.steps.train_s2(exp_dir, ckpt_dir)),
            ("train_s1", lambda: self.steps.train_s1(exp_dir, ckpt_dir)),
        ]
        sig = self._dataset_signature(name)
        states = self.step_states(name) if resume else {}
        try:
            for i, (step, fn) in enumerate(plan):
                if resume and states.get(step) == "completed":
                    continue  # artifacts valid and inputs unchanged
                if states.get(step) in ("partial", "stale"):
                    self._clean_step_artifacts(name, step)  # no half-written leftovers
                self.store.set_status(name, state="training", step=step, progress=i / len(plan))
                fn()
                self._mark_step_done(name, step, sig)
            self.store.set_status(name, state="trained", step=None, progress=1.0, error=None)
        except Exception as e:  # persist failure like the reference
            self.store.set_status(name, state="failed", error=str(e))

    def training_status(self, name: str) -> dict:
        return self._reconcile_orphaned(name)

    def infer(self, name: str, text: str, lang: str = "auto") -> tuple[int, np.ndarray]:
        if self.steps.synthesize is None:
            raise RuntimeError("inference not configured")
        st = self.store.status(name)
        if st.get("state") != "trained":
            raise RuntimeError(f"character {name} is not trained (state={st.get('state')})")
        p = self.store.path(name)
        # auto-select reference audio: first dataset slice (ref behavior:
        # training_service auto-selects ref audio/text)
        ds = os.path.join(p, "dataset")
        wavs = sorted(f for f in os.listdir(ds) if f.endswith(".wav"))
        if not wavs:
            raise RuntimeError("no reference audio available")
        return self.steps.synthesize(os.path.join(p, "ckpt"), text, lang, os.path.join(ds, wavs[0]))


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------


def make_handler(svc: TrainingService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code, obj, ctype="application/json"):
            body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            m = re.fullmatch(r"/api/v1/characters", path)
            if m:
                return self._send(200, {"characters": svc.store.list()})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/training/status", path)
            if m:
                name = m.group(1)
                if not svc.store.exists(name):
                    return self._send(404, {"message": "not found"})
                return self._send(200, svc.training_status(name))
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/labels", path)
            if m:
                name = m.group(1)
                if not svc.store.exists(name):
                    return self._send(404, {"message": "not found"})
                return self._send(200, {"labels": svc.store.read_labels(name)})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/audio/(?:files|status|check_status)", path)
            if m:
                name = m.group(1)
                if not svc.store.exists(name):
                    return self._send(404, {"message": "not found"})
                if path.endswith("/files"):
                    p = svc.store.path(name)
                    return self._send(200, {
                        "raw": sorted(os.listdir(os.path.join(p, "raw"))),
                        "dataset": sorted(os.listdir(os.path.join(p, "dataset"))),
                    })
                st = svc.store.status(name)
                return self._send(200, {"audio_state": st.get("audio_state", "unknown"), "slices": st.get("slices")})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/download/([\w.\-]+)", path)
            if m:
                name, fname = m.group(1), m.group(2)
                for sub in ("ckpt", "dataset", "raw"):
                    fp = os.path.join(svc.store.path(name), sub, fname)
                    if os.path.exists(fp):
                        with open(fp, "rb") as f:
                            return self._send(200, f.read(), "application/octet-stream")
                return self._send(404, {"message": "not found"})
            if path == "/api/v1/default_character":
                return self._send(200, {"name": svc.get_default()})
            m = re.fullmatch(r"/api/v1/inference/([0-9a-f]+)(/download)?", path)
            if m:
                job = svc.inference_job(m.group(1))
                if job is None:
                    return self._send(404, {"message": "not found"})
                if m.group(2):  # /download
                    if job.get("status") != "completed":
                        return self._send(409, {"message": f"job is {job.get('status')}"})
                    from gpt_sovits_tpu_torch.serve.api import wav_bytes

                    return self._send(200, wav_bytes(job["audio"], job["sr"]), "audio/wav")
                return self._send(200, {"status": job["status"], "error": job.get("error")})
            return self._send(404, {"message": "not found"})

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/api/v1/characters":
                try:
                    req = json.loads(self._body() or b"{}")
                    svc.store.create(req["name"])
                    return self._send(201, {"message": "created"})
                except FileExistsError:
                    return self._send(409, {"message": "exists"})
                except (KeyError, ValueError) as e:
                    return self._send(400, {"message": str(e)})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/audio", path)
            if m:
                name = m.group(1)
                if not svc.store.exists(name):
                    return self._send(404, {"message": "not found"})
                fname = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query).get("filename", ["upload.wav"])[0]
                n = svc.store.add_audio(name, fname, self._body())
                svc.invalidate(name, f"audio added: {fname}")
                return self._send(200, {"slices": n})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/manifest", path)
            if m:
                name = m.group(1)
                req = json.loads(self._body())
                p = svc.store.write_manifest(name, [tuple(e) for e in req["entries"]])
                return self._send(200, {"manifest": p})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/labels/(\d+)", path)
            if m:
                name, idx = m.group(1), int(m.group(2))
                try:
                    req = json.loads(self._body() or b"{}")
                    labels = svc.store.update_label(
                        name, idx, text=req.get("text"), lang=req.get("lang"), delete=bool(req.get("delete"))
                    )
                    return self._send(200, {"labels": labels})
                except IndexError:
                    return self._send(404, {"message": f"label {idx} out of range"})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/training/start", path)
            if m:
                name = m.group(1)
                try:
                    svc.start_training(name)
                    return self._send(202, {"message": "training started"})
                except FileNotFoundError:
                    return self._send(404, {"message": "not found"})
                except RuntimeError as e:
                    return self._send(409, {"message": str(e)})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/training/(check_status|clean)", path)
            if m:
                name = m.group(1)
                if not svc.store.exists(name):
                    return self._send(404, {"message": "not found"})
                if m.group(2) == "clean":
                    svc.clean_training(name)
                    return self._send(200, {"message": "cleaned"})
                return self._send(200, svc.check_training_status(name))
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/audio/process", path)
            if m:
                name = m.group(1)
                if not svc.store.exists(name):
                    return self._send(404, {"message": "not found"})
                try:
                    req = json.loads(self._body() or b"{}")
                    return self._send(200, svc.process_audio(name, denoise=bool(req.get("denoise"))))
                except Exception as e:
                    return self._send(500, {"message": str(e)})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/set_default", path)
            if m:
                try:
                    svc.set_default(m.group(1))
                    return self._send(200, {"message": "ok"})
                except FileNotFoundError:
                    return self._send(404, {"message": "not found"})
            if path == "/api/v1/inference":
                try:
                    req = json.loads(self._body())
                    name = req.get("character") or svc.get_default()
                    if not name:
                        return self._send(400, {"message": "no character given and no default set"})
                    if req.get("async"):
                        # reference contract: job id now, poll + download later
                        if svc.store.status(name).get("state") != "trained":
                            return self._send(400, {"message": f"character {name} is not trained"})
                        return self._send(202, {"inference_id": svc.start_inference(name, req["text"], req.get("lang", "auto"))})
                    sr, audio = svc.infer(name, req["text"], req.get("lang", "auto"))
                    from gpt_sovits_tpu_torch.serve.api import wav_bytes

                    return self._send(200, wav_bytes(audio, sr), "audio/wav")
                except (RuntimeError, KeyError, FileNotFoundError) as e:
                    return self._send(400, {"message": str(e)})
            return self._send(404, {"message": "not found"})

        def do_DELETE(self):
            path = urllib.parse.urlparse(self.path).path
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)", path)
            if m:
                try:
                    svc.store.delete(m.group(1))
                    return self._send(200, {"message": "deleted"})
                except FileNotFoundError:
                    return self._send(404, {"message": "not found"})
            m = re.fullmatch(r"/api/v1/characters/([\w\-]+)/audio/files/([\w.\-]+)", path)
            if m:
                name, fname = m.group(1), m.group(2)
                deleted = False
                for sub in ("raw", "dataset"):
                    fp = os.path.join(svc.store.path(name), sub, fname)
                    if os.path.exists(fp):
                        os.remove(fp)
                        deleted = True
                if deleted:  # model no longer reflects the data (ref :832-852)
                    svc.invalidate(name, f"audio deleted: {fname}")
                return self._send(200 if deleted else 404, {"message": "deleted" if deleted else "not found"})
            return self._send(404, {"message": "not found"})

    return Handler


def serve_training(svc: TrainingService, host="127.0.0.1", port=9881) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(svc))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
