"""Production step wiring for the training REST service (port of
gpt_sovits_tpu/serve/training_steps.py).

Counterpart of the reference fork's `server/training_steps.py`
(`StepProcessor`/`ConfigGenerator` — builds per-step env + config files and
launches subprocesses) and `server/service_config.py` (env-overridable
service settings). Here each step is a plain callable into
`gpt_sovits_tpu_torch.run` — one controller process, no env-var ABI — and the
settings come from a typed, env-overridable `ServiceConfig`. Every step
runs on `ServiceConfig.device`: the card unless it is "cpu".
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from gpt_sovits_tpu_torch.serve.training_service import TrainingService, TrainingSteps, serve_training


def _env(name: str, default):
    v = os.environ.get(name)
    if v is None:
        return default
    if isinstance(default, bool):
        return v.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(v)
    return v


@dataclass
class ServiceConfig:
    """Env-overridable service settings (reference service_config.py:12-35).

    Every field can be overridden via a `GSVT_*` environment variable; the
    pretrained paths are the equivalents of the reference's pretrained-path
    tables in config.py:12-75.
    """

    root: str = field(default_factory=lambda: _env("GSVT_SERVICE_ROOT", "characters"))
    host: str = field(default_factory=lambda: _env("GSVT_SERVICE_HOST", "127.0.0.1"))
    port: int = field(default_factory=lambda: _env("GSVT_SERVICE_PORT", 9881))
    version: str = field(default_factory=lambda: _env("GSVT_VERSION", "v2"))
    # pretrained / frozen model paths
    bert_path: Optional[str] = field(default_factory=lambda: _env("GSVT_BERT", None))
    hubert_path: Optional[str] = field(default_factory=lambda: _env("GSVT_HUBERT", None))
    sv_path: Optional[str] = field(default_factory=lambda: _env("GSVT_SV", None))
    pretrained_s2g: Optional[str] = field(default_factory=lambda: _env("GSVT_PRETRAINED_S2G", None))
    pretrained_s2d: Optional[str] = field(default_factory=lambda: _env("GSVT_PRETRAINED_S2D", None))
    pretrained_s1: Optional[str] = field(default_factory=lambda: _env("GSVT_PRETRAINED_S1", None))
    # training hyperparameters
    s1_epochs: int = field(default_factory=lambda: _env("GSVT_S1_EPOCHS", 15))
    s1_batch_size: int = field(default_factory=lambda: _env("GSVT_S1_BATCH_SIZE", 8))
    s2_epochs: int = field(default_factory=lambda: _env("GSVT_S2_EPOCHS", 8))
    s2_batch_size: int = field(default_factory=lambda: _env("GSVT_S2_BATCH_SIZE", 8))
    lora_rank: int = field(default_factory=lambda: _env("GSVT_LORA_RANK", 0))
    # ASR for /audio/process manifest generation
    asr_language: str = field(default_factory=lambda: _env("GSVT_ASR_LANGUAGE", "zh"))
    asr_enabled: bool = field(default_factory=lambda: _env("GSVT_ASR", True))
    # where the steps compute: None is the card (raises without one), "cpu" the CPU
    device: Optional[str] = None

    @property
    def is_pro(self) -> bool:
        return self.version in ("v2Pro", "v2ProPlus")

    @property
    def is_cfm(self) -> bool:
        return self.version in ("v3", "v4")


def _make_asr(cfg: ServiceConfig) -> Optional[Callable[[str], tuple[str, str]]]:
    """Per-file ASR callable, or None when no backend is importable
    (matches the reference's optional tools/asr dependencies)."""
    if not cfg.asr_enabled:
        return None
    lang = cfg.asr_language
    try:
        if lang in ("zh", "yue"):
            import funasr  # noqa: F401
        else:
            import faster_whisper  # noqa: F401
    except ImportError as e:
        import logging

        logging.getLogger(__name__).warning(
            "ASR enabled but no backend importable (%s): slices will be "
            "labeled with empty text and must be transcribed by hand — "
            "install funasr (zh/yue) or faster_whisper, or set GSVT_ASR=0 "
            "to silence this (reference tools/asr has the same optional deps)",
            e,
        )
        return None
    from gpt_sovits_tpu_torch.corpus.asr import make_transcriber

    transcribe = make_transcriber(lang)  # model built once, reused per slice

    def fn(path: str) -> tuple[str, str]:
        return lang.upper(), transcribe(path)

    return fn


def _manifest_text_for(ref_wav: str) -> Optional[str]:
    """Look up the transcript of a dataset slice in its files.list manifest
    (the reference auto-selects ref audio *and* its text)."""
    manifest = os.path.join(os.path.dirname(ref_wav), "files.list")
    if not os.path.exists(manifest):
        return None
    base = os.path.basename(ref_wav)
    with open(manifest, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|", 3)
            if len(parts) == 4 and os.path.basename(parts[0]) == base:
                return parts[3]
    return None


def _state_dir(ckpt_dir: str, step: str) -> str:
    """A trainer's own directory under the character's ckpt/ for its
    resumable state. The trainers name their states `state_{n}` alike, so in
    one shared directory S1 would resume from S2's (the JAX package's wiring
    does that: ROADMAP queue 3). Named `s2_state` / `s1_state`, it goes with
    its step's artifacts when the service cleans the step."""
    return os.path.join(ckpt_dir, f"{step}_state")


def _publish(res: Optional[dict], ckpt_dir: str) -> None:
    """The weight files a trainer exported, moved up into ckpt/, where the
    service and `synthesize` look for them."""
    for path in (res or {}).get("exports", []):
        os.replace(path, os.path.join(ckpt_dir, os.path.basename(path)))


def build_training_steps(cfg: ServiceConfig) -> TrainingSteps:
    """Wire TrainingSteps to the real pipeline: prepare -> S2 (GAN or CFM by
    version) -> S1, plus pipeline-backed synthesis with a per-checkpoint
    cache. Mirrors reference training_steps.py's step list
    (get_text/get_hubert/get_sv/get_semantic/sovits_training/gpt_training)."""
    from gpt_sovits_tpu_torch import run as run_mod

    def prepare(manifest: str, exp_dir: str) -> None:
        run_mod.run_prepare(
            manifest, exp_dir, version=cfg.version,
            bert=cfg.bert_path, hubert=cfg.hubert_path,
            s2=cfg.pretrained_s2g, sv=cfg.sv_path if cfg.is_pro else None, device=cfg.device,
        )

    def train_s2(exp_dir: str, ckpt_dir: str) -> None:
        work = _state_dir(ckpt_dir, "s2")
        if cfg.is_cfm:
            res = run_mod.run_train_v3(
                exp_dir, work, version=cfg.version,
                batch_size=cfg.s2_batch_size, epochs=cfg.s2_epochs,
                save_every=max(cfg.s2_epochs // 2, 1), lora_rank=cfg.lora_rank,
                pretrained=cfg.pretrained_s2g, device=cfg.device,
            )
        else:
            res = run_mod.run_train_s2(
                exp_dir, work, version=cfg.version,
                batch_size=cfg.s2_batch_size, epochs=cfg.s2_epochs,
                save_every=max(cfg.s2_epochs // 2, 1),
                pretrained_s2g=cfg.pretrained_s2g, pretrained_s2d=cfg.pretrained_s2d, device=cfg.device,
            )
        _publish(res, ckpt_dir)

    def train_s1(exp_dir: str, ckpt_dir: str) -> None:
        res = run_mod.run_train_s1(
            exp_dir, _state_dir(ckpt_dir, "s1"), batch_size=cfg.s1_batch_size,
            epochs=cfg.s1_epochs, save_every=max(cfg.s1_epochs // 3, 1),
            pretrained_s1=cfg.pretrained_s1, device=cfg.device,
        )
        _publish(res, ckpt_dir)

    # pipeline cache: rebuilding per request would reload the weights;
    # key on the resolved checkpoint paths (reference keeps one live TTS
    # pipeline and hot-swaps weights)
    _cache: dict[tuple[str, str], object] = {}
    _cache_lock = threading.Lock()

    def synthesize(ckpt_dir: str, text: str, lang: str, ref_wav: str) -> tuple[int, np.ndarray]:
        from gpt_sovits_tpu_torch.run import latest_step_model
        from gpt_sovits_tpu_torch.utils.loaders import build_pipeline

        s1 = latest_step_model(ckpt_dir, ".ckpt") or latest_step_model(ckpt_dir, ".npz")
        s2 = latest_step_model(ckpt_dir, ".pth")
        if not s1 or not s2:
            raise RuntimeError(f"no trained weights in {ckpt_dir}")
        # the whole set_ref_audio+run pair under the lock: inference jobs run
        # on their own threads, and the reference audio is pipeline state
        with _cache_lock:
            pipe = _cache.get((s1, s2))
            if pipe is None:
                pipe = build_pipeline(
                    s1_path=s1, s2_path=s2, version=cfg.version,
                    hubert_path=cfg.hubert_path, bert_path=cfg.bert_path,
                    sv_path=cfg.sv_path if cfg.is_pro else None, device=cfg.device,
                )
                _cache.clear()  # one live pipeline, like the reference
                _cache[(s1, s2)] = pipe
            pipe.set_ref_audio(ref_wav, ref_text=_manifest_text_for(ref_wav))
            return pipe.run(text, lang)

    return TrainingSteps(
        prepare=prepare, train_s2=train_s2, train_s1=train_s1,
        synthesize=synthesize, asr=_make_asr(cfg),
    )


def main(cfg: Optional[ServiceConfig] = None) -> None:
    """Launch the training service (reference start_service.sh equivalent)."""
    cfg = cfg or ServiceConfig()
    svc = TrainingService(cfg.root, build_training_steps(cfg), device=cfg.device)
    server = serve_training(svc, host=cfg.host, port=cfg.port)
    print(f"training service on {cfg.host}:{cfg.port} (root={cfg.root}, version={cfg.version})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
