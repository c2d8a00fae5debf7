"""ASR adapters producing the training manifest (port of
gpt_sovits_tpu/corpus/asr.py).

Counterparts of tools/asr/ (funasr_asr.py for zh/yue, fasterwhisper_asr.py
for the other languages). `funasr` and `faster_whisper` are optional and
imported only inside the functions that use them. The output is the
reference's `.list`: `path|speaker|LANG|text` an utterance.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional


def transcribe_funasr(wav_paths: Iterable[str], *, language: str = "zh") -> list[tuple[str, str]]:
    """zh/yue through FunASR's paraformer (+VAD+punc), as tools/asr/funasr_asr.py."""
    try:
        from funasr import AutoModel
    except ImportError as e:
        raise ImportError("funasr is not installed; install it or use an external ASR and write the .list "
                          "manifest directly") from e
    model = AutoModel(model="paraformer-zh", vad_model="fsmn-vad", punc_model="ct-punc")
    return [(p, model.generate(input=p)[0]["text"]) for p in wav_paths]


def transcribe_whisper(wav_paths: Iterable[str], *, language: Optional[str] = None,
                       model_size: str = "large-v3") -> list[tuple[str, str]]:
    """The other languages through faster-whisper (tools/asr/fasterwhisper_asr.py)."""
    try:
        from faster_whisper import WhisperModel
    except ImportError as e:
        raise ImportError("faster-whisper is not installed; install it or use an external ASR and write the "
                          ".list manifest directly") from e
    model = WhisperModel(model_size)
    out = []
    for p in wav_paths:
        segments, _ = model.transcribe(p, language=language)
        out.append((p, "".join(s.text for s in segments)))
    return out


def make_transcriber(language: str = "zh") -> Callable[[str], str]:
    """A one-file transcriber whose model is built once and kept (the
    functions above build it a call: fine for a directory, not a slice)."""
    if language in ("zh", "yue"):
        try:
            from funasr import AutoModel
        except ImportError as e:
            raise ImportError("funasr is not installed") from e
        model = AutoModel(model="paraformer-zh", vad_model="fsmn-vad", punc_model="ct-punc")
        return lambda path: model.generate(input=path)[0]["text"]
    try:
        from faster_whisper import WhisperModel
    except ImportError as e:
        raise ImportError("faster-whisper is not installed") from e
    model = WhisperModel("large-v3")

    def fn(path: str) -> str:
        segments, _ = model.transcribe(path, language=language)
        return "".join(s.text for s in segments)

    return fn


def write_manifest(entries: list[tuple[str, str]], out_path: str, *, speaker: str = "speaker",
                   language: str = "ZH") -> str:
    """Write the reference `.list` format (`path|speaker|LANG|text`)."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        for path, text in entries:
            text = text.replace("|", " ").replace("\n", " ").strip()
            if text:
                f.write(f"{path}|{speaker}|{language.upper()}|{text}\n")
    return out_path


def transcribe_dir(wav_dir: str, out_path: str, *, language: str = "zh", speaker: str = "speaker",
                   backend: Optional[Callable] = None) -> str:
    """A directory of wavs -> a `.list` manifest, the adapter picked by the
    language as the reference webui's ASR tab does."""
    wavs = sorted(os.path.join(wav_dir, f) for f in os.listdir(wav_dir) if f.lower().endswith((".wav", ".flac", ".mp3")))
    if backend is None:
        backend = transcribe_funasr if language in ("zh", "yue") else transcribe_whisper
    return write_manifest(backend(wavs, language=language), out_path, speaker=speaker, language=language)
