"""HTTP serving API, contract-compatible with the reference api_v2.py (port
of gpt_sovits_tpu/serve/api.py).

Endpoints (ref api_v2.py:300-500):
  GET/POST /tts            — synthesize; query params or JSON body with the
                             api_v2 field names (text, text_lang,
                             ref_audio_path, prompt_text, prompt_lang,
                             top_k/top_p/temperature, text_split_method,
                             speed_factor, fragment_interval, seed,
                             media_type wav|raw, sample_steps, ...)
  GET /set_gpt_weights     — hot-swap S1 weights (weights_path=...)
  GET /set_sovits_weights  — hot-swap S2 weights
  GET /control             — restart | exit (ref :252-257)
  GET /health              — liveness (addition)

Implementation: a thin standard-library http.server app. It serves every
language mode of `TTSService.LANGS` (zh, en, ja, ko, yue, auto and the all_*
modes; zh with BERT features when the pipeline has a BERT); a `text_lang`
outside `LANGS` answers 400.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from gpt_sovits_tpu_torch.text.segmentation import get_method

_BOOL = ("1", "true", "True", "yes")
_TRUE = (True, 1, "1", "true", "True", "yes")  # JSON bools or query strings


def wav_bytes(audio_int16: np.ndarray, sr: int) -> bytes:
    pcm = audio_int16.astype("<i2").tobytes()
    header = (
        b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
        + b"data" + struct.pack("<I", len(pcm))
    )
    return header + pcm


def wav_stream_header(sr: int) -> bytes:
    """Streaming wav header with zero data length (ref api_v2
    wave_header_chunk:237) — players read PCM until the stream closes."""
    return (
        b"RIFF" + struct.pack("<I", 36) + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
        + b"data" + struct.pack("<I", 0)
    )


def _ffmpeg_pack(audio_int16: np.ndarray, sr: int, args: list[str]) -> bytes:
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found")
    p = subprocess.run(
        ["ffmpeg", "-loglevel", "error", "-f", "s16le", "-ar", str(sr), "-ac", "1", "-i", "pipe:0"]
        + args + ["pipe:1"],
        input=audio_int16.astype("<i2").tobytes(), capture_output=True,
    )
    if p.returncode != 0:
        raise RuntimeError(f"ffmpeg failed: {p.stderr[-300:].decode(errors='replace')}")
    return p.stdout


def pack_ogg(audio_int16: np.ndarray, sr: int) -> bytes:
    """OGG container (api_v2.py:176-186): soundfile/Vorbis when importable,
    else ffmpeg/Opus; raises RuntimeError when no encoder is available
    (the endpoint reports 400 with this message)."""
    try:
        import io

        import soundfile as sf

        buf = io.BytesIO()
        sf.write(buf, audio_int16.astype(np.float32) / 32768.0, sr, format="OGG", subtype="VORBIS")
        return buf.getvalue()
    except ImportError:
        pass
    try:
        return _ffmpeg_pack(audio_int16, sr, ["-f", "ogg", "-c:a", "libopus"])
    except RuntimeError as e:
        raise RuntimeError(
            "media_type=ogg needs the soundfile package or an ffmpeg binary; "
            f"neither is available ({e})"
        ) from None


def pack_aac(audio_int16: np.ndarray, sr: int) -> bytes:
    """ADTS/AAC via ffmpeg (api_v2.py:189-205); RuntimeError when absent."""
    try:
        return _ffmpeg_pack(audio_int16, sr, ["-f", "adts", "-c:a", "aac", "-b:a", "128k"])
    except RuntimeError as e:
        raise RuntimeError(f"media_type=aac needs an ffmpeg binary ({e})") from None


_PACKERS = {"ogg": pack_ogg, "aac": pack_aac}


class TTSService:
    """Request validation + synthesis on top of a TTSPipeline
    (ref api_v2 check_params:262 + tts_handle:300)."""

    LANGS = ("auto", "zh", "en", "ja", "ko", "yue", "all_zh", "all_ja", "all_ko", "all_yue")

    def __init__(self, pipeline, *, weight_loader: Optional[Callable] = None, continuous=None):
        self.pipeline = pipeline
        self.weight_loader = weight_loader
        # optional ContinuousTTSService (serve/continuous_service.py): /tts
        # requests share the S1 slot pool and run concurrently
        self.continuous = continuous
        self._ref_key = None  # (path, aux, prompt_text, prompt_lang) prompt-cache key
        # legacy api.py default reference (DefaultRefer, api.py:177)
        self.default_ref = {"path": "", "text": "", "language": ""}
        # legacy api.py speaker registry (Speaker/speaker_list, api.py:358-369):
        # name -> weight paths + optional per-speaker default reference; the
        # `spk` request param hot-swaps weights through weight_loader
        self.speakers: dict = {}
        self.current_speaker: Optional[str] = None
        self.lock = threading.Lock()

    # -- speaker registry ----------------------------------------------------

    def list_speakers(self) -> tuple[int, bytes, str]:
        body = {"speakers": self.speakers, "current": self.current_speaker}
        return 200, json.dumps(body).encode(), "application/json"

    def register_speaker(self, req: dict) -> tuple[int, bytes, str]:
        """POST /speakers: {"name", "gpt_weights"?, "sovits_weights"?,
        "refer_wav_path"?, "prompt_text"?, "prompt_language"?}."""
        name = req.get("name", "")
        if not name:
            return 400, json.dumps({"message": "name is required"}).encode(), "application/json"
        for key in ("gpt_weights", "sovits_weights"):
            path = req.get(key)
            if path and not os.path.exists(path):
                return 400, json.dumps({"message": f"{key} not found: {path}"}).encode(), "application/json"
        with self.lock:
            self.speakers[name] = {
                "gpt_weights": req.get("gpt_weights", ""),
                "sovits_weights": req.get("sovits_weights", ""),
                "refer_wav_path": req.get("refer_wav_path", ""),
                "prompt_text": req.get("prompt_text", ""),
                "prompt_language": req.get("prompt_language", ""),
            }
        return 200, json.dumps({"code": 0, "message": "Success"}).encode(), "application/json"

    def _apply_speaker(self, req: dict) -> None:
        """Honor the `spk` param (api.py:843-850): swap to the speaker's
        weights when needed and fill missing reference fields from its
        registry entry. Raises ValueError for an unknown speaker."""
        spk = req.get("spk")
        if not spk:
            return
        if spk not in self.speakers:
            raise ValueError(f"unknown speaker: {spk}")
        entry = self.speakers[spk]
        if spk != self.current_speaker:
            if self.weight_loader is None and (entry["gpt_weights"] or entry["sovits_weights"]):
                raise ValueError("speaker weight hot-swap not configured")
            with self._swap_guard():
                if entry["gpt_weights"]:
                    self.weight_loader("gpt", entry["gpt_weights"])
                if entry["sovits_weights"]:
                    self.weight_loader("sovits", entry["sovits_weights"])
            self._ref_key = None  # prompt cache belongs to the old weights
            self.current_speaker = spk
        if entry["refer_wav_path"]:
            req.setdefault("ref_audio_path", entry["refer_wav_path"])
            req.setdefault("refer_wav_path", entry["refer_wav_path"])
            if entry["prompt_text"]:
                req.setdefault("prompt_text", entry["prompt_text"])
            if entry["prompt_language"]:
                # the legacy route reads prompt_language, /tts prompt_lang
                req.setdefault("prompt_language", entry["prompt_language"])
                req.setdefault("prompt_lang", entry["prompt_language"])

    # -- legacy api.py contract (GET/POST "/", /change_refer) ---------------

    def change_refer(self, req: dict) -> tuple[int, bytes, str]:
        """api.py:1079 handle_change: set the default reference."""
        path = req.get("refer_wav_path", "")
        text = req.get("prompt_text", "")
        lang = req.get("prompt_language", "")
        if not (path and text and lang):
            return 400, json.dumps({"code": 400, "message": "missing refer_wav_path/prompt_text/prompt_language"}).encode(), "application/json"
        self.default_ref = {"path": path, "text": text, "language": lang}
        return 200, json.dumps({"code": 0, "message": "Success"}).encode(), "application/json"

    @staticmethod
    def _cut_by_punc(text: str, punc: str) -> str:
        """api.py cut_text: insert newlines at the given punctuation set."""
        if not punc:
            return text
        puncs = [p for p in ",.;?!、，。？！;：…" if p in punc]
        if not puncs:
            return text
        import re as _re

        items = _re.split("(" + "|".join(map(_re.escape, puncs)) + ")", text)
        merged = ["".join(g) for g in zip(items[::2], items[1::2])]
        if len(items) % 2 == 1 and items[-1]:
            merged.append(items[-1])
        return "\n".join(m for m in merged if m.strip())

    def legacy_tts(self, req: dict) -> tuple[int, bytes, str]:
        """api.py:1100 handle: param names of the legacy endpoint mapped to
        the modern service; falls back to the /change_refer default."""
        try:
            with self.lock:
                self._apply_speaker(req)
        except ValueError as e:
            return 400, json.dumps({"code": 400, "message": str(e)}).encode(), "application/json"
        path = req.get("refer_wav_path") or self.default_ref["path"]
        ptext = req.get("prompt_text") or self.default_ref["text"]
        plang = req.get("prompt_language") or self.default_ref["language"]
        if not (path and ptext and plang):
            return 400, json.dumps({"code": 400, "message": "no reference given and no default set"}).encode(), "application/json"
        text = req.get("text", "")
        if "cut_punc" in req and req["cut_punc"]:
            text = self._cut_by_punc(text, req["cut_punc"])
        # the legacy endpoint accepts display-name languages (api.py dict_language)
        zh_names = {
            "中文": "zh", "英文": "en", "日文": "ja", "韩文": "ko", "粤语": "yue",
            "中英混合": "zh", "日英混合": "ja", "韩英混合": "ko", "粤英混合": "yue", "多语种混合": "auto",
        }
        tlang = req.get("text_language", "")
        tlang = zh_names.get(tlang, tlang)
        modern = {
            "ref_audio_path": path,
            "prompt_text": ptext,
            "prompt_lang": plang,
            "text": text,
            "text_lang": tlang,
            "text_split_method": "cut0" if req.get("cut_punc") else "cut5",
            "media_type": "wav",
        }
        for src, dst in (("top_k", "top_k"), ("top_p", "top_p"), ("temperature", "temperature"), ("speed", "speed_factor"), ("sample_steps", "sample_steps")):
            if src in req:
                modern[dst] = req[src]
        return self.tts(modern)

    def validate(self, req: dict) -> Optional[tuple[int, str]]:
        if not req.get("ref_audio_path"):
            return 400, "ref_audio_path is required"
        if not req.get("text"):
            return 400, "text is required"
        if not req.get("text_lang"):
            return 400, "text_lang is required"
        if req["text_lang"].lower() not in self.LANGS:
            return 400, f"text_lang: {req['text_lang']} is not supported"
        media = req.get("media_type", "wav")
        # wav/raw always; ogg/aac via encoder adapters (reference packers
        # api_v2.py:176-233 — the reference limits ogg to streaming mode,
        # here ogg/aac pack the complete clip in non-streaming responses)
        if media not in ("wav", "raw", "ogg", "aac"):
            return 400, f"media_type: {media} is not supported"
        try:
            get_method(req.get("text_split_method", "cut5"))
        except ValueError:
            return 400, f"text_split_method:{req.get('text_split_method')} is not supported"
        return None

    def _ensure_ref(self, req: dict) -> None:
        """(Re)build the prompt cache when the main or aux reference set
        changes (TTS.py:1093-1109 prompt-cache invalidation)."""
        ref_path = req["ref_audio_path"]
        aux = req.get("aux_ref_audio_paths") or []
        if isinstance(aux, str):
            aux = [p for p in aux.split(",") if p]
        aux = tuple(aux)
        ptext = req.get("prompt_text") or None
        plang = (req.get("prompt_lang") or "auto").lower()
        key = (ref_path, aux, ptext, plang)
        if key != self._ref_key:
            self.pipeline.set_ref_audio(
                ref_path, ref_text=ptext, aux_wavs=list(aux) or None, ref_lang=plang
            )
            self._ref_key = key

    def tts_stream(self, req: dict):
        """Streaming synthesis: yields (sr, pcm-bytes fragments).
        Raises ValueError on bad input (validate first)."""
        with self.lock:
            self._ensure_ref(req)
            seed = int(req.get("seed", -1))
            if seed < 0:
                seed = int(np.random.default_rng().integers(0, 2**31 - 1))
            gen = self.pipeline.run_streaming(
                req["text"], req["text_lang"].lower(), seed=seed,
                cut_method=req.get("text_split_method", "cut5"),
            )
            for sr, frag in gen:
                yield sr, frag.astype("<i2").tobytes()

    def tts(self, req: dict) -> tuple[int, bytes, str]:
        # Continuous serving mode: /tts requests go through the shared S1
        # slot pool and synthesize concurrently (the lock only covers the
        # speaker swap and the prompt-cache set-up). The RefCache snapshot is
        # taken inside the lock and travels with the request, so concurrent
        # requests with different references cannot voice each other's. An
        # explicit serial decode (parallel_infer false) takes run().
        if self.continuous is not None and req.get("parallel_infer", True) in _TRUE:
            with self.lock:
                try:
                    self._apply_speaker(req)
                except ValueError as e:
                    return 400, json.dumps({"message": str(e)}).encode(), "application/json"
                err = self.validate(req)
                if err:
                    return err[0], json.dumps({"message": err[1]}).encode(), "application/json"
                try:
                    self._ensure_ref(req)
                except (ValueError, FileNotFoundError) as e:
                    return 400, json.dumps({"message": str(e)}).encode(), "application/json"
                ref = self.pipeline.ref  # snapshot under the lock
            try:
                sr, audio = self.continuous.synthesize(
                    req["text"], req["text_lang"].lower(),
                    ref=ref,
                    speed=float(req.get("speed_factor", 1.0)),
                    text_split_method=req.get("text_split_method"),
                    top_k=int(req["top_k"]) if "top_k" in req else None,
                    top_p=float(req["top_p"]) if "top_p" in req else None,
                    temperature=float(req["temperature"]) if "temperature" in req else None,
                    repetition_penalty=float(req["repetition_penalty"]) if "repetition_penalty" in req else None,
                    seed=int(req["seed"]) if int(req.get("seed", -1)) >= 0 else None,
                    fragment_interval=float(req["fragment_interval"]) if "fragment_interval" in req else None,
                )
            except (ValueError, TimeoutError) as e:
                return 400, json.dumps({"message": str(e)}).encode(), "application/json"
            return self._pack_audio(req, sr, audio)

        # ONE lock acquisition across speaker swap + validate + synthesis:
        # releasing between them lets a concurrent request hot-swap to
        # another speaker's weights before this one synthesizes
        with self.lock:
            try:
                self._apply_speaker(req)
            except ValueError as e:
                return 400, json.dumps({"message": str(e)}).encode(), "application/json"
            err = self.validate(req)
            if err:
                return err[0], json.dumps({"message": err[1]}).encode(), "application/json"
            try:
                self._ensure_ref(req)
                seed = int(req.get("seed", -1))
                if seed < 0:
                    seed = np.random.default_rng().integers(0, 2**31 - 1)
                sr, audio = self.pipeline.run(
                    req["text"],
                    req["text_lang"].lower(),
                    seed=int(seed),
                    cut_method=req.get("text_split_method", "cut5"),
                    top_k=int(req["top_k"]) if "top_k" in req else None,
                    top_p=float(req["top_p"]) if "top_p" in req else None,
                    temperature=float(req["temperature"]) if "temperature" in req else None,
                    repetition_penalty=float(req["repetition_penalty"]) if "repetition_penalty" in req else None,
                    speed=float(req.get("speed_factor", 1.0)),
                    fragment_interval=float(req["fragment_interval"]) if "fragment_interval" in req else None,
                    batch_size=int(req["batch_size"]) if "batch_size" in req else None,
                    batch_threshold=float(req.get("batch_threshold", 0.75)),
                    split_bucket=req.get("split_bucket", True) in _TRUE,
                    parallel_infer=req.get("parallel_infer", True) in _TRUE,
                    sample_steps=int(req["sample_steps"]) if "sample_steps" in req else None,
                    super_sampling=(req.get("super_sampling") in _TRUE) if "super_sampling" in req else None,
                )
            except (ValueError, FileNotFoundError) as e:
                return 400, json.dumps({"message": str(e)}).encode(), "application/json"
            except Exception as e:  # TTS.py:1352-1363 — recover and report
                self.pipeline.recover()
                self._ref_key = None
                return 500, json.dumps({"message": f"internal error (recovered): {e}"}).encode(), "application/json"
        return self._pack_audio(req, sr, audio)

    def _pack_audio(self, req: dict, sr: int, audio) -> tuple[int, bytes, str]:
        media = req.get("media_type", "wav")
        if media == "raw":
            return 200, audio.astype("<i2").tobytes(), "audio/raw"
        if media in _PACKERS:
            try:
                return 200, _PACKERS[media](audio, sr), f"audio/{media}"
            except RuntimeError as e:
                return 400, json.dumps({"message": str(e)}).encode(), "application/json"
        return 200, wav_bytes(audio, sr), "audio/wav"

    def set_refer_audio(self, path: str) -> tuple[int, bytes, str]:
        """GET /set_refer_audio (api_v2.py:441-448): pre-set the reference."""
        try:
            with self.lock:
                self.pipeline.set_ref_audio(path)
                self._ref_key = (path, (), None, "auto")
            return 200, json.dumps({"message": "success"}).encode(), "application/json"
        except Exception as e:
            return 400, json.dumps({"message": "set refer audio failed", "Exception": str(e)}).encode(), "application/json"

    def _swap_guard(self):
        """Weight swaps quiesce the continuous slot pool: jobs in flight
        finish on the old weights end to end, then the batcher is rebuilt
        from the new ones (otherwise the pool would keep decoding with the
        old S1 weights while S2 uses the new ones)."""
        if self.continuous is not None:
            return self.continuous.paused_for_weight_swap()
        return contextlib.nullcontext()

    def set_weights(self, which: str, path: str) -> tuple[int, bytes, str]:
        if self.weight_loader is None:
            return 400, json.dumps({"message": "weight hot-swap not configured"}).encode(), "application/json"
        try:
            with self.lock:
                with self._swap_guard():
                    self.weight_loader(which, path)
                # manual weight loads supersede any registry speaker: a later
                # spk=<current> request must re-swap, and the prompt cache
                # belongs to the old weights
                self.current_speaker = None
                self._ref_key = None
            return 200, json.dumps({"message": "success"}).encode(), "application/json"
        except Exception as e:  # mirror api_v2's catch-all error payload
            return 400, json.dumps({"message": f"change {which} weight failed", "Exception": str(e)}).encode(), "application/json"


_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>gpt_sovits_tpu</title>
<style>
 body{font-family:system-ui;margin:2rem auto;max-width:42rem;line-height:1.5}
 label{display:block;margin-top:.8rem;font-weight:600}
 input,textarea,select{width:100%;padding:.4rem;box-sizing:border-box}
 button{margin-top:1rem;padding:.5rem 1.5rem;font-size:1rem}
 #status{margin-top:1rem;color:#555}
</style></head><body>
<h1>gpt_sovits_tpu</h1>
<p>Zero-shot voice cloning. Reference audio path must be readable by the server.</p>
<label>Text</label><textarea id="text" rows="4">Hello, this is a test.</textarea>
<label>Language</label>
<select id="lang"><option>auto</option><option>en</option><option>zh</option><option>ja</option><option>ko</option></select>
<label>Reference audio path (3-10 s wav)</label><input id="ref" placeholder="/path/to/ref.wav">
<label>Reference transcript (optional)</label><input id="ref_text">
<label>Seed</label><input id="seed" value="42">
<button onclick="go()">Synthesize</button>
<div id="status"></div><audio id="player" controls style="width:100%;margin-top:1rem"></audio>
<script>
async function go(){
  const s=document.getElementById('status'); s.textContent='synthesizing...';
  const q=new URLSearchParams({text:text.value,text_lang:lang.value,
    ref_audio_path:ref.value,prompt_text:ref_text.value,seed:seed.value});
  const r=await fetch('/tts?'+q);
  if(!r.ok){s.textContent='error: '+await r.text();return}
  const blob=await r.blob();
  player.src=URL.createObjectURL(blob); player.play();
  s.textContent='done';
}
</script></body></html>""".encode()


def make_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _params(self) -> dict:
            parsed = urllib.parse.urlparse(self.path)
            return {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}

        def _stream_tts(self, params: dict):
            try:
                with service.lock:
                    service._apply_speaker(params)
            except ValueError as e:
                self._send(400, json.dumps({"message": str(e)}).encode(), "application/json")
                return
            err = service.validate(params)
            if err:
                self._send(err[0], json.dumps({"message": err[1]}).encode(), "application/json")
                return
            try:
                gen = service.tts_stream(params)
                first = next(gen, None)
            except (ValueError, FileNotFoundError) as e:
                self._send(400, json.dumps({"message": str(e)}).encode(), "application/json")
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Connection", "close")
            self.end_headers()
            if first is None:
                return
            sr, frag = first
            self.wfile.write(wav_stream_header(sr))
            self.wfile.write(frag)
            for _, frag in gen:
                self.wfile.write(frag)

        def do_GET(self):
            route = urllib.parse.urlparse(self.path).path
            params = self._params()
            if route == "/" and params.get("text"):  # legacy api.py GET /
                self._send(*service.legacy_tts(params))
            elif route in ("/", "/index.html"):
                self._send(200, _INDEX_HTML, "text/html; charset=utf-8")
            elif route == "/change_refer":
                self._send(*service.change_refer(params))
            elif route == "/health":
                self._send(200, b'{"status":"ok"}', "application/json")
            elif route == "/tts" and params.get("streaming_mode") in _BOOL:
                self._stream_tts(params)
            elif route == "/tts":
                self._send(*service.tts(params))
            elif route == "/speakers":
                self._send(*service.list_speakers())
            elif route == "/set_refer_audio":
                self._send(*service.set_refer_audio(params.get("refer_audio_path", "")))
            elif route == "/set_gpt_weights":
                self._send(*service.set_weights("gpt", params.get("weights_path", "")))
            elif route == "/set_sovits_weights":
                self._send(*service.set_weights("sovits", params.get("weights_path", "")))
            elif route == "/control":
                cmd = params.get("command", "")
                if cmd == "exit":
                    self._send(200, b"{}", "application/json")
                    threading.Thread(target=self.server.shutdown, daemon=True).start()
                elif cmd == "restart":
                    # re-exec the serving process (api_v2.py:252-257)
                    import os as _os
                    import sys as _sys

                    self._send(200, b"{}", "application/json")

                    def _restart():
                        self.server.shutdown()
                        _os.execl(_sys.executable, _sys.executable, *_sys.argv)

                    threading.Thread(target=_restart, daemon=True).start()
                else:
                    self._send(400, json.dumps({"message": f"unsupported command {cmd}"}).encode(), "application/json")
            else:
                self._send(404, b'{"message":"not found"}', "application/json")

        def do_POST(self):
            route = urllib.parse.urlparse(self.path).path
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                params = json.loads(body) if body else {}
            except json.JSONDecodeError:
                self._send(400, b'{"message":"invalid json"}', "application/json")
                return
            if route == "/tts" and params.get("streaming_mode") in _TRUE:
                self._stream_tts(params)
            elif route == "/tts":
                self._send(*service.tts(params))
            elif route == "/":  # legacy api.py POST /
                self._send(*service.legacy_tts(params))
            elif route == "/change_refer":
                self._send(*service.change_refer(params))
            elif route == "/speakers":
                self._send(*service.register_speaker(params))
            else:
                self._send(404, b'{"message":"not found"}', "application/json")

    return Handler


def serve(service: TTSService, host: str = "127.0.0.1", port: int = 9880) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server

