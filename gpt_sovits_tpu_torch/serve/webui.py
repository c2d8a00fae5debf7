"""Web control panel — the reference master webui equivalent (port of
gpt_sovits_tpu/serve/webui.py).

The reference `webui.py` (port 9874) is a Gradio app whose every action
spawns a subprocess with env-var GPU sharding (webui.py:1082-1096): tabs for
UVR5 separation / slicing / denoise / ASR / label proofreading (subfix), the
1A/1B/1C feature-extraction stages, 1Ba/1Bb training, and an inference-webui
launcher. Here the same surface is a dependency-free single-page app over a
`ThreadingHTTPServer`: every action runs as a logged background job in the
single controller process, calling the shared library entry points
(`gpt_sovits_tpu_torch.run`, `corpus/*`, `dsp/*`) directly — no subprocess/env ABI.
The tools that run a model take `device` (default the card, "cpu" for the
CPU); `denoise` takes an FRCRN checkpoint as `model` (the spectral gate
without one, as in the JAX package).

Endpoints:
  GET  /                   single-page UI
  GET  /api/jobs           all jobs (newest first)
  GET  /api/jobs/{id}      one job with its log tail
  POST /api/run/{tool}     start a job; tools: slice denoise asr separate
                           prepare train_s1 train_s2 train_v3 one_click
  GET  /api/labels?list=   read a .list manifest (subfix equivalent)
  POST /api/labels         edit one entry {list, index, text?, lang?, delete?}
  GET  /api/models?root=   newest trained weights per version
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable


class JobRunner:
    """Background jobs with captured logs (replaces the reference's Popen +
    stdout panes; `state` mirrors its per-step status text)."""

    def __init__(self):
        self._jobs: dict[str, dict] = {}
        self._lock = threading.Lock()

    def start(self, name: str, fn: Callable[[Callable], None]) -> str:
        job_id = uuid.uuid4().hex[:10]
        job = {"id": job_id, "name": name, "state": "running", "log": [],
               "error": None, "started": time.time(), "finished": None}
        with self._lock:
            self._jobs[job_id] = job

        def log(*parts, **_kw):
            line = " ".join(str(p) for p in parts)
            with self._lock:
                job["log"].append(line)

        def run():
            try:
                fn(log)
                job["state"] = "done"
            except Exception as e:  # persist failure like the reference status text
                job["state"] = "failed"
                job["error"] = f"{type(e).__name__}: {e}"
            finally:
                job["finished"] = time.time()

        threading.Thread(target=run, daemon=True).start()
        return job_id

    def get(self, job_id: str) -> dict | None:
        with self._lock:
            j = self._jobs.get(job_id)
            return dict(j, log=list(j["log"])) if j else None

    def list(self) -> list[dict]:
        with self._lock:
            return [
                {k: v for k, v in j.items() if k != "log"}
                for j in sorted(self._jobs.values(), key=lambda j: -j["started"])
            ]


# ---------------------------------------------------------------------------
# Tools (each takes the JSON params dict + a log callable)
# ---------------------------------------------------------------------------


def _wavs_in(d: str) -> list[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.lower().endswith((".wav", ".flac", ".mp3"))]


def tool_slice(p: dict, log) -> None:
    from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, save_wav
    from gpt_sovits_tpu_torch.dsp.slicer import Slicer

    out_dir = p["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    inputs = _wavs_in(p["input"]) if os.path.isdir(p["input"]) else [p["input"]]
    total = 0
    for path in inputs:
        wav, sr = load_wav(path)
        slicer = Slicer(sr, threshold=float(p.get("threshold", -34.0)),
                        min_length=int(p.get("min_length", 4000)),
                        min_interval=int(p.get("min_interval", 300)),
                        hop_size=int(p.get("hop_size", 10)),
                        max_sil_kept=int(p.get("max_sil_kept", 500)))
        base = os.path.splitext(os.path.basename(path))[0]
        n = 0
        for i, chunk in enumerate(slicer.slice(wav)):
            save_wav(os.path.join(out_dir, f"{base}_{i:04d}.wav"), chunk, sr)
            n = i + 1
        log(f"{path}: {n} slices")
        total += n
    log(f"wrote {total} slices to {out_dir}")


def tool_denoise(p: dict, log) -> None:
    from gpt_sovits_tpu_torch.corpus.denoise import denoise_frcrn, spectral_gate
    from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, save_wav

    os.makedirs(p["out_dir"], exist_ok=True)
    paths = _wavs_in(p["in_dir"])
    for path in paths:
        wav, sr = load_wav(path)
        out = denoise_frcrn(wav, sr, p["model"], p.get("device")) if p.get("model") else spectral_gate(wav, sr)
        save_wav(os.path.join(p["out_dir"], os.path.basename(path)), out, sr)
        log("denoised", os.path.basename(path))
    log(f"denoised {len(paths)} files -> {p['out_dir']}")


def tool_asr(p: dict, log) -> None:
    from gpt_sovits_tpu_torch.corpus.asr import transcribe_dir

    out = transcribe_dir(p["in_dir"], p["output"], language=p.get("language", "zh"),
                         speaker=p.get("speaker", "speaker"))
    log("wrote manifest:", out)


def tool_separate(p: dict, log) -> None:
    from gpt_sovits_tpu_torch.corpus.uvr5 import separate_vocals
    from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, save_wav

    os.makedirs(p["vocal_dir"], exist_ok=True)
    os.makedirs(p["other_dir"], exist_ok=True)
    paths = _wavs_in(p["in_dir"]) if p.get("in_dir") else [p["input"]]
    for path in paths:
        wav, sr = load_wav(path, mono=False)
        if wav.ndim == 2:
            wav = wav.T
        vocals, other = separate_vocals(wav, sr, backend=p.get("backend", "auto"),
                                        model_path=p.get("model"), config_path=p.get("config"),
                                        agg=int(p.get("agg", 10)), device=p.get("device"))
        base = os.path.splitext(os.path.basename(path))[0]
        save_wav(os.path.join(p["vocal_dir"], f"vocal_{base}.wav"), vocals.T if vocals.ndim == 2 else vocals, sr)
        save_wav(os.path.join(p["other_dir"], f"instrument_{base}.wav"), other.T if other.ndim == 2 else other, sr)
        log("separated", os.path.basename(path))
    log(f"separated {len(paths)} files")


def tool_prepare(p: dict, log) -> None:
    from gpt_sovits_tpu_torch.run import run_prepare

    run_prepare(p["list"], p["exp_dir"], version=p.get("version", "v2"),
                bert=p.get("bert"), hubert=p.get("hubert"), s2=p.get("s2"),
                sv=p.get("sv"), device=p.get("device"), log=log)


def tool_train_s1(p: dict, log) -> None:
    from gpt_sovits_tpu_torch.run import run_train_s1

    run_train_s1(p["exp_dir"], p["ckpt_dir"], batch_size=int(p.get("batch_size", 8)),
                 epochs=int(p.get("epochs", 15)), save_every=int(p.get("save_every", 5)),
                 dpo=bool(p.get("dpo", False)), pretrained_s1=p.get("pretrained_s1"),
                 device=p.get("device"), log=log)


def tool_train_s2(p: dict, log) -> None:
    from gpt_sovits_tpu_torch.run import run_train_s2

    run_train_s2(p["exp_dir"], p["ckpt_dir"], version=p.get("version", "v2"),
                 batch_size=int(p.get("batch_size", 8)), epochs=int(p.get("epochs", 8)),
                 save_every=int(p.get("save_every", 4)),
                 pretrained_s2g=p.get("pretrained_s2g"), pretrained_s2d=p.get("pretrained_s2d"),
                 device=p.get("device"), log=log)


def tool_train_v3(p: dict, log) -> None:
    from gpt_sovits_tpu_torch.run import run_train_v3

    run_train_v3(p["exp_dir"], p["ckpt_dir"], version=p.get("version", "v3"),
                 batch_size=int(p.get("batch_size", 4)), epochs=int(p.get("epochs", 4)),
                 save_every=int(p.get("save_every", 2)), lora_rank=int(p.get("lora_rank", 0)),
                 pretrained=p.get("pretrained"), device=p.get("device"), log=log)


_TTS_CACHE: dict = {}
_TTS_LOCK = threading.Lock()


def tool_tts(p: dict, log) -> None:
    """In-process synthesis (the reference webui launches inference_webui;
    here it is a tab). The pipeline is cached by model paths; the output wav
    lands at p['output'] and the job log carries the phase line."""
    from gpt_sovits_tpu_torch.dsp.audio_io import save_wav
    from gpt_sovits_tpu_torch.utils.loaders import build_pipeline

    import numpy as np

    key = (p.get("s1"), p.get("s2"), p.get("version"), p.get("hubert"), p.get("bert"), p.get("sv"), p.get("device"))
    # one lock around set_ref_audio+run: jobs run on their own threads and
    # the reference audio is pipeline state, not a run() argument
    with _TTS_LOCK:
        pipe = _TTS_CACHE.get(key)
        if pipe is None:
            log("loading models...")
            pipe = build_pipeline(s1_path=p.get("s1"), s2_path=p.get("s2"), version=p.get("version"),
                                  hubert_path=p.get("hubert"), bert_path=p.get("bert"), sv_path=p.get("sv"),
                                  device=p.get("device"))
            _TTS_CACHE.clear()
            _TTS_CACHE[key] = pipe
        pipe.set_ref_audio(p["ref_audio"], ref_text=p.get("ref_text"), ref_lang=p.get("ref_lang", "auto"))
        sr, audio = pipe.run(p["text"], p.get("lang", "auto"), seed=int(p.get("seed", 0)),
                             cut_method=p.get("cut", "cut5"))
    out = p.get("output") or os.path.join(os.path.dirname(p["ref_audio"]), "webui_tts.wav")
    save_wav(out, audio.astype(np.float32) / 32768.0, sr)
    log(f"wrote {out} ({len(audio) / sr:.2f}s @ {sr} Hz)")
    log("AUDIO:" + out)  # the page turns this into an <audio> player


def tool_one_click(p: dict, log) -> None:
    """slice -> (denoise) -> asr -> prepare, the reference's `open1abc`
    one-click pipeline (webui.py:1047) as one chained job."""
    work = p["work_dir"]
    sliced = os.path.join(work, "sliced")
    tool_slice({**p, "input": p["input"], "out_dir": sliced}, log)
    src = sliced
    if p.get("denoise"):
        den = os.path.join(work, "denoised")
        tool_denoise({"in_dir": sliced, "out_dir": den, "model": p.get("denoise_model"),
                      "device": p.get("device")}, log)
        src = den
    manifest = os.path.join(work, "files.list")
    tool_asr({"in_dir": src, "output": manifest, "language": p.get("language", "zh"),
              "speaker": p.get("speaker", "speaker")}, log)
    tool_prepare({**p, "list": manifest, "exp_dir": os.path.join(work, "exp")}, log)


TOOLS: dict[str, Callable[[dict, Callable], None]] = {
    "slice": tool_slice, "denoise": tool_denoise, "asr": tool_asr,
    "separate": tool_separate, "prepare": tool_prepare, "train_s1": tool_train_s1,
    "train_s2": tool_train_s2, "train_v3": tool_train_v3, "one_click": tool_one_click,
    "tts": tool_tts,
}


# ---------------------------------------------------------------------------
# Label proofreading over a .list manifest (subfix_webui equivalent)
# ---------------------------------------------------------------------------


def read_labels(list_path: str) -> list[dict]:
    out = []
    with open(list_path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|", 3)
            if len(parts) == 4:
                out.append({"path": parts[0], "speaker": parts[1], "lang": parts[2], "text": parts[3]})
    return out


def edit_label(list_path: str, index: int, *, text=None, lang=None, delete=False) -> list[dict]:
    labels = read_labels(list_path)
    if not (0 <= index < len(labels)):
        raise IndexError(index)
    if delete:
        labels.pop(index)
    else:
        if text is not None:
            labels[index]["text"] = text.replace("|", " ")
        if lang is not None:
            labels[index]["lang"] = lang
    tmp = list_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        for l in labels:
            f.write(f"{l['path']}|{l['speaker']}|{l['lang']}|{l['text']}\n")
    os.replace(tmp, list_path)
    return labels


# ---------------------------------------------------------------------------
# HTTP layer + page
# ---------------------------------------------------------------------------

_PAGE_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>gpt_sovits_tpu webui</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1a1a2e}
 header{background:#1a1a2e;color:#fff;padding:10px 20px}
 nav button{margin-right:6px;padding:6px 12px;border:0;border-radius:4px;cursor:pointer}
 nav button.on{background:#4f6df5;color:#fff}
 main{padding:20px;max-width:980px}
 .tab{display:none}.tab.on{display:block}
 fieldset{border:1px solid #ccd;border-radius:6px;margin-bottom:14px;background:#fff}
 label{display:block;margin:6px 0 2px;font-size:13px}
 input,select{width:320px;padding:4px}
 button.go{margin-top:10px;padding:6px 16px;background:#4f6df5;color:#fff;border:0;border-radius:4px;cursor:pointer}
 pre{background:#101020;color:#ade;padding:10px;border-radius:6px;max-height:300px;overflow:auto;font-size:12px}
 table{border-collapse:collapse;width:100%;background:#fff}
 td,th{border:1px solid #dde;padding:4px 8px;font-size:13px}
 .done{color:#2a2}.failed{color:#c22}.running{color:#c80}
</style></head><body>
<header><b>gpt_sovits_tpu</b> — __SUBTITLE__</header>
<nav style="padding:10px 20px"></nav>
<main></main>
<script>
const I18N = __I18N_JSON__;
const tr = s => I18N[s] || s;
const TABS = {
 "Data tools": [
  ["slice", [["input","input wav or dir"],["out_dir","output dir"],["threshold","-34"],["min_length","4000"]]],
  ["denoise", [["in_dir","input dir"],["out_dir","output dir"]]],
  ["separate", [["input","input wav"],["in_dir","(or) input dir"],["vocal_dir","vocals out"],["other_dir","instrument out"],["model","model path (optional)"],["backend","auto"]]],
  ["asr", [["in_dir","sliced wav dir"],["output",".list manifest path"],["language","zh"],["speaker","speaker"]]],
 ],
 "Dataset": [
  ["prepare", [["list",".list manifest"],["exp_dir","exp dir"],["version","v2"],["bert","bert path"],["hubert","hubert path"],["s2","pretrained s2G (for semantic)"],["sv","sv model (Pro)"]]],
  ["one_click", [["input","raw audio"],["work_dir","work dir"],["language","zh"],["bert","bert path"],["hubert","hubert path"],["s2","pretrained s2G"]]],
 ],
 "Inference": [
  ["tts", [["text","text to synthesize"],["lang","auto"],["ref_audio","reference wav"],["ref_text","reference transcript"],["s1","GPT .ckpt"],["s2","SoVITS .pth"],["version",""],["hubert","hubert dir"],["bert","bert dir (zh)"],["output","out wav path"],["seed","0"]]],
 ],
 "Training": [
  ["train_s2", [["exp_dir","exp dir"],["ckpt_dir","ckpt dir"],["version","v2"],["batch_size","8"],["epochs","8"],["pretrained_s2g","s2G .pth"],["pretrained_s2d","s2D .pth"]]],
  ["train_v3", [["exp_dir","exp dir"],["ckpt_dir","ckpt dir"],["version","v3"],["batch_size","4"],["epochs","4"],["lora_rank","0"],["pretrained","SoVITS v3/v4 .pth"]]],
  ["train_s1", [["exp_dir","exp dir"],["ckpt_dir","ckpt dir"],["batch_size","8"],["epochs","15"],["pretrained_s1","s1 .ckpt"]]],
 ],
};
const nav = document.querySelector("nav"), mainEl = document.querySelector("main");
const tabs = Object.keys(TABS).concat(["Labels","Jobs"]);
let cur = tabs[0];
function mkTab(name){
 const div = document.createElement("div"); div.className = "tab"; div.dataset.name = name;
 if (TABS[name]) for (const [tool, fields] of TABS[name]) {
   const fs = document.createElement("fieldset");
   fs.innerHTML = `<legend><b>${tool}</b></legend>` + fields.map(([k, ph]) =>
     `<label>${k}</label><input name="${k}" placeholder="${ph}">`).join("") +
     `<br><button class="go" onclick="runTool('${tool}', this)">${tr("Run")} ${tool}</button>`;
   div.appendChild(fs);
 }
 if (name === "Labels") div.innerHTML = `
   <fieldset><legend><b>${tr("label proofreading")}</b></legend>
   <label>.list path</label><input id="lbl-list"><button class="go" onclick="loadLabels()">${tr("Load")}</button>
   <div id="lbl-table"></div></fieldset>`;
 if (name === "Jobs") div.innerHTML = `<div id="jobs"></div><pre id="joblog"></pre>`;
 return div;
}
for (const t of tabs) {
 const b = document.createElement("button"); b.textContent = tr(t); b.dataset.name = t;
 b.onclick = () => { cur = t; render(); };
 nav.appendChild(b);
 mainEl.appendChild(mkTab(t));
}
function render(){
 nav.querySelectorAll("button").forEach(b => b.classList.toggle("on", b.dataset.name === cur));
 mainEl.querySelectorAll(".tab").forEach(d => d.classList.toggle("on", d.dataset.name === cur));
 if (cur === "Jobs") refreshJobs();
}
async function runTool(tool, btn){
 const params = {};
 btn.closest("fieldset").querySelectorAll("input").forEach(i => { if (i.value) params[i.name] = i.value; });
 const r = await fetch("/api/run/" + tool, {method:"POST", body: JSON.stringify(params)});
 const j = await r.json();
 if (!r.ok) { alert(j.error || "error"); return; }
 cur = "Jobs"; render(); watch(j.id);
}
let watching = null;
async function watch(id){
 watching = id;
 const log = document.getElementById("joblog");
 while (watching === id) {
   const j = await (await fetch("/api/jobs/" + id)).json();
   log.textContent = `[${j.name}] ${j.state}` + (j.error ? " — " + j.error : "") + "\\n" + j.log.join("\\n");
   const au = j.log.find(l => l.startsWith("AUDIO:"));
   if (au && j.state === "done") {
     let el = document.getElementById("player");
     if (!el) { el = document.createElement("audio"); el.id = "player"; el.controls = true; log.parentNode.insertBefore(el, log); }
     el.src = "/api/audio?path=" + encodeURIComponent(au.slice(6));
   }
   refreshJobs();
   if (j.state !== "running") break;
   await new Promise(r => setTimeout(r, 1000));
 }
}
async function refreshJobs(){
 const js = await (await fetch("/api/jobs")).json();
 document.getElementById("jobs").innerHTML = "<table><tr><th>job</th><th>state</th><th></th></tr>" +
  js.jobs.map(j => `<tr><td>${j.name}</td><td class="${j.state}">${j.state}</td>
   <td><button onclick="watch('${j.id}')">log</button></td></tr>`).join("") + "</table>";
}
async function loadLabels(){
 const list = document.getElementById("lbl-list").value;
 const j = await (await fetch("/api/labels?list=" + encodeURIComponent(list))).json();
 document.getElementById("lbl-table").innerHTML = "<table><tr><th>#</th><th>path</th><th>lang</th><th>text</th><th></th></tr>" +
  j.labels.map((l, i) => `<tr><td>${i}</td><td>${l.path.split("/").pop()}</td>
   <td><input style="width:50px" value="${l.lang}" id="lang${i}"></td>
   <td><input style="width:420px" value="${l.text.replace(/"/g,'&quot;')}" id="text${i}"></td>
   <td><button onclick="saveLabel(${i})">save</button> <button onclick="delLabel(${i})">del</button></td></tr>`).join("") + "</table>";
}
async function saveLabel(i){
 const list = document.getElementById("lbl-list").value;
 await fetch("/api/labels", {method:"POST", body: JSON.stringify({list, index: i,
   text: document.getElementById("text"+i).value, lang: document.getElementById("lang"+i).value})});
 loadLabels();
}
async function delLabel(i){
 const list = document.getElementById("lbl-list").value;
 await fetch("/api/labels", {method:"POST", body: JSON.stringify({list, index: i, delete: true})});
 loadLabels();
}
render();
</script></body></html>"""


def _render_page(language: str | None = None) -> str:
    """Fill the page template with the locale map for `language` (the
    `lang` query param or the browser's Accept-Language), ref tools/i18n."""
    import json as _json

    from gpt_sovits_tpu_torch.utils.i18n import I18nAuto

    i18n = I18nAuto(language or None)
    return _PAGE_TEMPLATE.replace("__I18N_JSON__", _json.dumps(i18n.mapping(), ensure_ascii=False)).replace(
        "__SUBTITLE__", i18n("TPU-native GPT-SoVITS control panel")
    )



def make_handler(runner: JobRunner):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, obj, ctype="application/json"):
            body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            if url.path in ("/", "/index.html"):
                lang = q.get("lang") or (self.headers.get("Accept-Language") or "").split(",")[0].split(";")[0].strip()
                self._send(200, _render_page(lang).encode(), "text/html; charset=utf-8")
            elif url.path == "/api/jobs":
                self._send(200, {"jobs": runner.list()})
            elif url.path.startswith("/api/jobs/"):
                j = runner.get(url.path.rsplit("/", 1)[1])
                self._send(200, j) if j else self._send(404, {"error": "no such job"})
            elif url.path == "/api/labels":
                try:
                    self._send(200, {"labels": read_labels(q["list"])})
                except (KeyError, OSError) as e:
                    self._send(400, {"error": str(e)})
            elif url.path == "/api/audio":
                path = q.get("path", "")
                if not (path.endswith(".wav") and os.path.exists(path)):
                    self._send(404, {"error": "no such wav"})
                    return
                with open(path, "rb") as f:
                    self._send(200, f.read(), "audio/wav")
            elif url.path == "/api/models":
                from gpt_sovits_tpu_torch.run import latest_step_model

                root = q.get("root", ".")
                out = {}
                for version in ("v1", "v2", "v2Pro", "v2ProPlus", "v3", "v4"):
                    suffix = "" if version == "v1" else f"_{version}"
                    gpt = latest_step_model(os.path.join(root, f"GPT_weights{suffix}"), ".ckpt")
                    sovits = latest_step_model(os.path.join(root, f"SoVITS_weights{suffix}"), ".pth")
                    if gpt or sovits:
                        out[version] = {"gpt": gpt, "sovits": sovits}
                self._send(200, out)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            if url.path.startswith("/api/run/"):
                tool = url.path.rsplit("/", 1)[1]
                fn = TOOLS.get(tool)
                if fn is None:
                    self._send(404, {"error": f"unknown tool {tool!r}"})
                    return
                try:
                    params = self._body()
                except json.JSONDecodeError as e:
                    self._send(400, {"error": str(e)})
                    return
                job_id = runner.start(tool, lambda log: fn(params, log))
                self._send(202, {"id": job_id})
            elif url.path == "/api/labels":
                try:
                    b = self._body()
                    labels = edit_label(b["list"], int(b["index"]), text=b.get("text"),
                                        lang=b.get("lang"), delete=bool(b.get("delete")))
                    self._send(200, {"labels": labels})
                except (KeyError, IndexError, OSError, json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})
            else:
                self._send(404, {"error": "not found"})

    return Handler


def serve_webui(host: str = "127.0.0.1", port: int = 9874) -> ThreadingHTTPServer:
    """Start the panel (reference webui port 9874). Returns the server;
    callers drive serve_forever()."""
    if host not in ("127.0.0.1", "localhost", "::1"):
        print(f"warning: webui on {host} is unauthenticated and can read/write "
              "files and start jobs with the server's permissions — bind to "
              "127.0.0.1 or front it with an authenticating proxy")
    runner = JobRunner()
    srv = ThreadingHTTPServer((host, port), make_handler(runner))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
