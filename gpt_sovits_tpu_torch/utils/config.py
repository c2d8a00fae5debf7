"""Typed configuration (a copy of the inference part of
gpt_sovits_tpu/utils/config.py: MelConfig, S1Config, S2Config,
InferenceConfig, s2_config_for_version)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

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

    @property
    def phoneme_vocab_size(self) -> int:
        return 732 if self.version != "v1" else 322

    @property
    def is_pro(self) -> bool:
        return self.version in ("v2Pro", "v2ProPlus")


@dataclass(frozen=True)
class InferenceConfig:
    """Serving knobs (reference: TTS_Config, TTS.py:217-409 and run() kwargs)."""

    report_timing: bool = False  # print the per-request phase line (TTS.py:1317)
    top_k: int = 15
    top_p: float = 1.0
    temperature: float = 1.0
    repetition_penalty: float = 1.35
    text_split_method: str = "cut5"
    batch_size: int = 8
    fragment_interval: float = 0.3
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
