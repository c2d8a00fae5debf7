"""Typed configuration (a copy of gpt_sovits_tpu/utils/config.py's
MelConfig, MEL_V3, MEL_V4, S1Config, S2Config, TrainConfig, MeshConfig,
InferenceConfig, s2_config_for_version, the readers of the reference's
config files and asdict/to_json/replace) and the v4 vocoder's constants of
gpt_sovits_tpu/utils/loaders.py `load_vocoder`."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Sequence

# ---------------------------------------------------------------------------
# Model versions. Reference behavior matrix: GPT_SoVITS/TTS_infer_pack/TTS.py
# (version sniffing at init_vits_weights, TTS.py:484) and module/models.py.
# ---------------------------------------------------------------------------
VERSIONS = ("v1", "v2", "v2Pro", "v2ProPlus", "v3", "v4")


@dataclass(frozen=True)
class MelConfig:
    """STFT/mel parameters (reference: module/mel_processing.py:40-144)."""

    sampling_rate: int = 32000
    n_fft: int = 2048
    win_size: int = 2048
    hop_size: int = 640
    num_mels: int = 128
    fmin: float = 0.0
    fmax: float | None = None


# Per-version mel configs used by the pipeline
# (reference: TTS.py mel_fn / mel_fn_v4 closures and configs/s2.json "data").
MEL_V3 = MelConfig(sampling_rate=24000, n_fft=1024, win_size=1024, hop_size=256, num_mels=100)
MEL_V4 = MelConfig(sampling_rate=32000, n_fft=1280, win_size=1280, hop_size=320, num_mels=100)


@dataclass(frozen=True)
class S1Config:
    """S1 AR text-to-semantic model (reference: configs/s1longer-v2.yaml,
    AR/models/t2s_model.py:260)."""

    vocab_size: int = 1025  # 1024 semantic codes + EOS
    phoneme_vocab_size: int = 732  # v2 symbols table size
    embedding_dim: int = 512
    hidden_dim: int = 512
    num_heads: int = 16
    ffn_dim: int = 2048
    num_layers: int = 24
    dropout: float = 0.0
    eos_id: int = 1024
    bert_dim: int = 1024  # chinese-roberta-wwm-ext-large hidden size
    max_len: int = 4096  # positional table size (ref embedding.py precomputes 4000)
    # decoding
    max_new_tokens: int = 1500  # ref t2s_model.py:701 decode cap
    semantic_frame_rate: int = 25  # Hz


@dataclass(frozen=True)
class S2Config:
    """S2 SoVITS synthesizer (reference: configs/s2.json "model",
    module/models.py:796 SynthesizerTrn)."""

    version: str = "v2"
    spec_channels: int = 1025  # n_fft//2 + 1
    segment_size: int = 32  # latent frames (20480 samples / 640 hop)
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (10, 8, 2, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 8, 2, 2)
    gin_channels: int = 512
    mrte_hidden: int = 512  # MRTE cross-attn width (ref mrte_model.py:13)
    ssl_dim: int = 768
    n_codes: int = 1024
    semantic_frame_rate: str = "25hz"
    freeze_quantizer: bool = True
    # v2Pro speaker-verification conditioning (ref models.py:895-911)
    sv_dim: int = 20480
    # v3/v4 CFM path
    cfm_mel_channels: int = 100
    cfm_dit_depth: int = 22
    cfm_dit_dim: int = 1024
    cfm_dit_heads: int = 16

    @property
    def phoneme_vocab_size(self) -> int:
        return 732 if self.version != "v1" else 322

    @property
    def is_pro(self) -> bool:
        return self.version in ("v2Pro", "v2ProPlus")

    @property
    def is_cfm(self) -> bool:
        return self.version in ("v3", "v4")


@dataclass(frozen=True)
class TrainConfig:
    """Shared optimization knobs (reference: configs/s2.json "train" and
    s1longer-v2.yaml "train"/"optimizer")."""

    seed: int = 1234
    epochs: int = 100
    batch_size: int = 32
    learning_rate: float = 1e-4
    betas: tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.999875
    segment_size: int = 20480
    c_mel: float = 45.0
    c_kl: float = 1.0
    text_low_lr_rate: float = 0.4
    grad_accum: int = 1
    warmup_steps: int = 2000
    max_sec: int = 54
    grad_clip: float = 1.0
    save_every_n_epoch: int = 1


@dataclass(frozen=True)
class MeshConfig:
    """The (data, model) device mesh of parallel/mesh.py: data parallelism
    over batches, tensor parallelism of the wide weights."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all remaining processes
    model_parallel: int = 1


@dataclass(frozen=True)
class InferenceConfig:
    """Serving knobs (reference: TTS_Config, TTS.py:217-409 and run() kwargs)."""

    report_timing: bool = False  # print the per-request phase line (TTS.py:1317)
    version: str = "v2"  # the model version the config names; TTSPipeline takes its own from its models
    top_k: int = 15
    top_p: float = 1.0
    temperature: float = 1.0
    repetition_penalty: float = 1.35
    text_split_method: str = "cut5"
    batch_size: int = 8
    fragment_interval: float = 0.3
    sample_steps: int = 32  # CFM Euler steps (v3/v4)
    max_ref_sec: float = 10.0
    min_ref_sec: float = 3.0


def s2_config_for_version(version: str) -> "S2Config":
    """Per-version S2 hyperparameters (reference: configs/s2*.json and
    TTS.py init paths)."""
    if version not in VERSIONS:
        raise ValueError(f"unknown version {version!r}")
    base = S2Config(version=version)
    if version in ("v2Pro", "v2ProPlus"):
        base = dataclasses.replace(base, gin_channels=1024)
    if version == "v2ProPlus":
        base = dataclasses.replace(base, upsample_initial_channel=768)
    return base


def vocoder_v4_config() -> "S2Config":
    """The v4 vocoder: the HiFiGAN Generator at x480 (mel frames at 100 Hz
    to 48 kHz), reference TTS.py:631-655."""
    return dataclasses.replace(
        s2_config_for_version("v4"),
        upsample_rates=(10, 6, 2, 2, 2), upsample_kernel_sizes=(20, 12, 4, 4, 4), upsample_initial_channel=512,
    )


def s2_config_from_reference_json(path: str, version: str = "v2") -> "S2Config":
    """A reference configs/s2*.json (utils.get_hparams HParams) in the typed
    tree."""
    with open(path, encoding="utf-8") as f:
        d = json.load(f)
    m = d.get("model", {})
    data = d.get("data", {})
    return S2Config(
        version=version,
        spec_channels=data.get("filter_length", 2048) // 2 + 1,
        segment_size=d.get("train", {}).get("segment_size", 20480) // data.get("hop_length", 640),
        inter_channels=m.get("inter_channels", 192),
        hidden_channels=m.get("hidden_channels", 192),
        filter_channels=m.get("filter_channels", 768),
        n_heads=m.get("n_heads", 2),
        n_layers=m.get("n_layers", 6),
        kernel_size=m.get("kernel_size", 3),
        p_dropout=m.get("p_dropout", 0.1),
        resblock_kernel_sizes=tuple(m.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilation_sizes=tuple(tuple(x) for x in m.get("resblock_dilation_sizes", ((1, 3, 5),) * 3)),
        upsample_rates=tuple(m.get("upsample_rates", (10, 8, 2, 2, 2))),
        upsample_initial_channel=m.get("upsample_initial_channel", 512),
        upsample_kernel_sizes=tuple(m.get("upsample_kernel_sizes", (16, 16, 8, 2, 2))),
        gin_channels=m.get("gin_channels", 512),
        semantic_frame_rate=m.get("semantic_frame_rate", "25hz"),
        freeze_quantizer=bool(m.get("freeze_quantizer", True)),
    )


def s1_config_from_reference_yaml(path: str) -> "S1Config":
    """A reference configs/s1*.yaml in the typed tree (PyYAML is imported
    here: the card's machine may lack it)."""
    import yaml

    with open(path, encoding="utf-8") as f:
        d = yaml.safe_load(f)
    m = d.get("model", {})
    return S1Config(
        vocab_size=m.get("vocab_size", 1025),
        phoneme_vocab_size=m.get("phoneme_vocab_size", 732),
        embedding_dim=m.get("embedding_dim", 512),
        hidden_dim=m.get("hidden_dim", 512),
        num_heads=m.get("head", 16),
        ffn_dim=m.get("hidden_dim", 512) * 4,
        num_layers=m.get("n_layer", 24),
        dropout=float(m.get("dropout", 0.0)),
        eos_id=m.get("EOS", 1024),
    )


def inference_config_from_reference_yaml(path: str, version: str = "v2") -> "InferenceConfig":
    """The `version` (else `custom`) section of a reference
    configs/tts_infer.yaml (TTS_Config); as the JAX reader, it takes the
    section's version only."""
    import yaml

    with open(path, encoding="utf-8") as f:
        d = yaml.safe_load(f) or {}
    sec = d.get(version, d.get("custom", {})) or {}
    return InferenceConfig(version=sec.get("version", version))


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(asdict(cfg), indent=2, default=str)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
