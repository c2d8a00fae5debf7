"""Zero-shot TTS pipeline, v2 family (port of
gpt_sovits_tpu/infer/pipeline.py: `TTSPipeline.set_ref_audio` + `run`).

  * set_ref_audio: reference wav -> 16 kHz CNHuBERT features -> VQ prompt
    semantic tokens; linear spectrogram for timbre; v2Pro/v2ProPlus also
    the ERes2NetV2 speaker embedding of the 16 kHz audio
  * preprocess: cut method -> g2p -> phone ids (English; BERT features are
    zeros for every non-zh language, so BERT is not on this path)
  * run: length-sorted greedy bucketing, batched S1 decode, one S2 decode
    per bucket, inter-fragment silence, original order restored, int16

On a GPU the S1 step runs the CUDA kernels of ops/decode_step.py (int8
weights and int8 KV by default, as the JAX package on an accelerator) and
the vocoder runs in bf16. The JAX package's TPU devices (compile-cache
buckets for padded shapes, the lane-folded vocoder, the cross-group
launch/fetch overlap over a slow host link) have no counterpart here; the
padded shapes are kept so that both packages run the same computation.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from gpt_sovits_tpu_torch import resolve_device
from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, resample
from gpt_sovits_tpu_torch.dsp.mel import spectrogram
from gpt_sovits_tpu_torch.models.eres2net import kaldi_fbank
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder, generate
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.ops.decode_step import stack_weights_from_params
from gpt_sovits_tpu_torch.text import cleaned_text_to_sequence
from gpt_sovits_tpu_torch.text.cleaner import check_language, clean_text
from gpt_sovits_tpu_torch.text.segmentation import get_method, split_big_text
from gpt_sovits_tpu_torch.utils.config import InferenceConfig, MelConfig
from gpt_sovits_tpu_torch.utils.metrics import PhaseTimer, ThroughputMeter

BERT_DIM = 1024


def _split_batches(sorted_lens: list, batch_size: int, threshold: float) -> list[list[int]]:
    """Greedy batch splitting over length-sorted items (to_batch,
    TTS.py:858-879): a candidate batch shrinks from the tail until its
    median/mean length ratio reaches `threshold`."""
    groups: list[list[int]] = []
    pos, n = 0, len(sorted_lens)
    while pos < n:
        pos_end = min(pos + batch_size, n)
        while pos < pos_end:
            lens = sorted_lens[pos:pos_end]
            score = lens[(pos_end - pos) // 2] / (sum(lens) / len(lens) + 1e-8)
            if score >= threshold or pos_end - pos == 1:
                groups.append(list(range(pos, pos_end)))
                pos = pos_end
                break
            pos_end -= 1
    return groups


def snap_speed(speed: float) -> float:
    """Snap a speed factor to a 0.05 grid in [0.5, 2.0] (as the JAX package,
    so both produce the same output lengths)."""
    s = min(max(float(speed), 0.5), 2.0)
    return round(round(s / 0.05) * 0.05, 2)


def _next_bucket(n: int, buckets=(32, 64, 128, 256, 512)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def _wav_to_i16(wav: torch.Tensor) -> torch.Tensor:
    """Vocoder output -> int16 PCM on the device (clip, scale, truncate)."""
    return (torch.clamp(wav, -1.0, 1.0).float() * 32767.0).to(torch.int16)


def phones_right(batch, tx_max) -> np.ndarray:
    """RIGHT-padded phone ids for the S2 text encoder."""
    out = np.zeros((len(batch), tx_max), np.int64)
    for i, s in enumerate(batch):
        out[i, : len(s["phones"])] = s["phones"]
    return out


@dataclasses.dataclass
class RefCache:
    """Cached per-reference features."""

    prompt_semantic: np.ndarray  # (Tp,) int
    refer_spec: np.ndarray  # (Tr, spec_channels)
    sv_emb: Optional[np.ndarray] = None  # (sv_dim,) for v2Pro/v2ProPlus


class TTSPipeline:
    def __init__(
        self,
        *,
        s1_model: T2SDecoder,
        s2_model: SynthesizerTrn,
        hubert_model,
        sv_model=None,
        mel_cfg: MelConfig = MelConfig(),
        infer_cfg: InferenceConfig = InferenceConfig(),
        use_fused_s1: Optional[bool] = None,  # default: on for a GPU
        s1_weight_quant: Optional[str] = None,  # "int8" | "bf16"; default int8 on a GPU
        s1_kv_quant: Optional[str] = None,  # "int8" | "bf16"; default int8 on a GPU
        half: Optional[bool] = None,  # bf16 vocoder; default on a GPU
        device=None,  # None: CUDA (raises without a card); "cpu" for the tests
    ):
        self.device = resolve_device(device)
        on_gpu = self.device.type == "cuda"
        self.s1 = s1_model.to(self.device).eval()
        self.s2 = s2_model.to(self.device).eval()
        self.hubert = hubert_model.to(self.device).eval()
        self.sv = sv_model.to(self.device).eval() if sv_model is not None else None
        self.mel_cfg = mel_cfg
        self.cfg = infer_cfg
        self.version = s2_model.cfg.version
        if self.version not in ("v1", "v2", "v2Pro", "v2ProPlus"):
            raise NotImplementedError(f"S2 version {self.version}: v3/v4 are not ported yet (ROADMAP.md, M8-M10)")
        self.ref: Optional[RefCache] = None
        self.use_fused_s1 = on_gpu if use_fused_s1 is None else use_fused_s1
        self.s1_weight_quant = s1_weight_quant or ("int8" if on_gpu else "bf16")
        self.s1_kv_quant = s1_kv_quant or ("int8" if on_gpu else "bf16")
        self.half = on_gpu if half is None else half
        self._s1_weights = (
            stack_weights_from_params(self.s1.state_dict(), self.s1.cfg.num_layers, quant=self.s1_weight_quant)
            if self.use_fused_s1 else None
        )
        self._voc_dtype = torch.bfloat16 if self.half else torch.float32
        self._dec = copy.deepcopy(self.s2.dec).to(self._voc_dtype) if self.half else self.s2.dec
        self.meter = ThroughputMeter()
        self.last_timing: dict = {}

    # ------------------------------------------------------------------
    # reference audio
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _ref_spec_sv(self, wav, sr: int):
        """spec (+ v2Pro sv emb) for one reference clip (_get_ref_spec,
        TTS.py:758-793)."""
        sr_native = self.mel_cfg.sampling_rate
        wav_native = resample(np.asarray(wav, np.float32), sr, sr_native)
        maxx = float(np.abs(wav_native).max()) if wav_native.size else 0.0
        if maxx > 1.0:
            wav_native = wav_native / min(2.0, maxx)
        spec = spectrogram(torch.from_numpy(wav_native[None]).to(self.device), self.mel_cfg)[0].T
        sv_emb = None
        if self.s2.cfg.is_pro and self.sv is not None:
            wav16 = resample(wav_native, sr_native, 16000)
            feat = kaldi_fbank(torch.from_numpy(wav16[None]).to(self.device))
            sv_emb = self.sv(feat)[0].float().cpu().numpy()
        return spec.float().cpu().numpy(), sv_emb

    @torch.no_grad()
    def set_ref_audio(self, wav, sr: Optional[int] = None):
        """wav: path or float array. Extracts and caches prompt features
        (the reference text matters only to v3/v4, which are not ported)."""
        if isinstance(wav, str):
            wav, sr = load_wav(wav)
        if sr is None:
            raise ValueError("sr required for array input")
        dur = len(wav) / sr
        if not (self.cfg.min_ref_sec <= dur <= self.cfg.max_ref_sec):
            raise ValueError(
                f"reference audio must be {self.cfg.min_ref_sec:.0f}-{self.cfg.max_ref_sec:.0f} s, got {dur:.1f} s"
            )
        wav16 = resample(np.asarray(wav, np.float32), sr, 16000)
        wav16 = np.concatenate([wav16, np.zeros(int(16000 * 0.3), np.float32)])  # zero_wav 0.3 s tail
        ssl = self.hubert(torch.from_numpy(wav16[None]).to(self.device))
        codes = self.s2.extract_latent(ssl)
        spec, sv_emb = self._ref_spec_sv(wav, sr)
        self.ref = RefCache(prompt_semantic=codes[0].cpu().numpy(), refer_spec=spec, sv_emb=sv_emb)
        return self.ref

    # ------------------------------------------------------------------
    # text
    # ------------------------------------------------------------------

    def _g2p_segment(self, text: str, language: str):
        """One segment -> (phone ids, bert features (T, 1024) zeros, norm)."""
        check_language(language)
        text = re.sub(r" {2,}", " ", text)
        phones, _, norm = clean_text(text, "en", self.version)
        ids = cleaned_text_to_sequence(phones, self.version)
        return ids, np.zeros((len(ids), BERT_DIM), np.float32), norm

    def preprocess(self, text: str, language: str, cut_method: str = "cut5"):
        """-> list of {"phones": ids, "bert": (T,1024), "norm_text"} segments."""
        check_language(language)
        pieces = []
        for chunk in get_method(cut_method)(text.strip()):
            pieces.extend(split_big_text(chunk))
        out = []
        for piece in pieces:
            phones, bert, norm = self._g2p_segment(piece, language)
            if len(phones) < 2:
                continue
            if out and len(phones) < 6:  # short fragments merge into the previous segment
                prev = out[-1]
                prev["phones"] = prev["phones"] + phones
                prev["bert"] = np.concatenate([prev["bert"], bert], axis=0)
                prev["norm_text"] += norm
                continue
            out.append({"phones": phones, "bert": bert, "norm_text": norm})
        return out

    # ------------------------------------------------------------------
    # synthesis
    # ------------------------------------------------------------------

    @torch.no_grad()
    def run(
        self,
        text: str,
        language: str = "en",
        *,
        seed: int = 0,
        cut_method: Optional[str] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        repetition_penalty: Optional[float] = None,
        speed: float = 1.0,
        fragment_interval: Optional[float] = None,
        max_sec: int = 30,
        batch_size: Optional[int] = None,
        batch_threshold: float = 0.75,
        split_bucket: bool = True,
        parallel_infer: bool = True,
        early_stop_num: Optional[int] = None,
    ) -> tuple[int, np.ndarray]:
        """Synthesize. Returns (sample_rate, int16 waveform)."""
        if self.ref is None:
            raise RuntimeError("call set_ref_audio first")
        cfg = self.cfg
        s1_kw = dict(
            top_k=cfg.top_k if top_k is None else top_k,
            top_p=cfg.top_p if top_p is None else top_p,
            temperature=cfg.temperature if temperature is None else temperature,
            repetition_penalty=cfg.repetition_penalty if repetition_penalty is None else repetition_penalty,
            max_sec=max_sec, early_stop_num=early_stop_num,
        )
        fragment_interval = cfg.fragment_interval if fragment_interval is None else fragment_interval
        speed = snap_speed(speed)

        timer = PhaseTimer()
        with timer.phase("preprocess"):
            segments = self.preprocess(text, language, cut_method or cfg.text_split_method)
        if not segments:
            raise ValueError("no synthesizable text")
        order = (
            sorted(range(len(segments)), key=lambda i: len(segments[i]["phones"]))
            if split_bucket and parallel_infer
            else list(range(len(segments)))
        )
        bs = (batch_size or cfg.batch_size) if parallel_infer else 1
        if split_bucket and parallel_infer:
            groups = _split_batches([len(segments[i]["phones"]) for i in order], bs, batch_threshold)
        else:
            groups = [list(range(s, min(s + bs, len(order)))) for s in range(0, len(order), bs)]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        wavs: dict[int, np.ndarray] = {}
        self.last_tokens: dict[int, int] = {}  # semantic tokens per segment, in reading order
        for group in groups:
            idx = [order[g] for g in group]
            batch = [segments[i] for i in idx]
            with timer.phase("s1"):
                s1 = self._s1_launch(batch, gen, **s1_kw)
                lengths = s1[0].lengths.tolist()  # host read: S1 is done
            with timer.phase("s2"):
                for i, w in zip(idx, self._s2_fetch(self._s2_launch(batch, s1, max(lengths), speed=speed))):
                    wavs[i] = w
            self.last_tokens.update(zip(idx, lengths))

        sr = self.mel_cfg.sampling_rate
        silence = np.zeros(int(sr * fragment_interval), np.float32)
        pieces = []
        for i in range(len(segments)):
            pieces.append(wavs[i])
            pieces.append(silence)
        audio = np.clip(np.concatenate(pieces[:-1]), -1.0, 1.0)
        self.meter.measure_done(len(audio) / sr, sum(timer.phases.values()))
        self.last_timing = dict(timer.phases)
        if cfg.report_timing:
            print(timer.report(), f"audio:{len(audio) / sr:.2f}s")
        return sr, (audio * 32767.0).astype(np.int16)

    def _s1_launch(self, batch, generator, *, top_k, top_p, temperature, repetition_penalty, max_sec,
                   early_stop_num=None):
        b = len(batch)
        dev = self.device
        prompt = self.ref.prompt_semantic
        tp = len(prompt)
        tx_max = _next_bucket(max(len(s["phones"]) for s in batch))
        phones = np.zeros((b, tx_max), np.int64)
        bert = np.zeros((b, tx_max, BERT_DIM), np.float32)
        x_lens = np.zeros((b,), np.int64)
        for i, s in enumerate(batch):
            n = len(s["phones"])
            phones[i, tx_max - n :] = s["phones"]  # LEFT pad
            bert[i, tx_max - n :] = s["bert"][:n]
            x_lens[i] = n
        out = generate(
            self.s1,
            torch.from_numpy(phones).to(dev), torch.from_numpy(x_lens).to(dev), torch.from_numpy(bert).to(dev),
            torch.from_numpy(np.broadcast_to(prompt, (b, tp)).astype(np.int64)).to(dev),
            torch.full((b,), tp, dtype=torch.long, device=dev), generator,
            max_new_tokens=int(self.s1.cfg.semantic_frame_rate * max_sec),
            top_k=top_k, top_p=top_p, temperature=temperature, repetition_penalty=repetition_penalty,
            early_stop_num=-1 if early_stop_num is None else early_stop_num,
            use_fused_kernel=self.use_fused_s1, weight_quant=self.s1_weight_quant,
            kv_cache_quant=self.s1_kv_quant, fused_weights=self._s1_weights,
        )
        return out, tx_max

    def _s2_launch(self, batch, s1_state, n_max: int, *, speed):
        """S2 at the bucketed width of the longest row (the JAX package's
        non-eager choice; its eager full-width dispatch hides a host-link
        round trip that a locally attached card does not have)."""
        out, tx_max = s1_state
        b = len(batch)
        dev = self.device
        ref = self.ref
        codes = out.tokens[:, : _next_bucket(n_max)]
        refer_spec = torch.from_numpy(np.repeat(ref.refer_spec[None], b, axis=0)).to(dev)
        refer_lens = torch.full((b,), ref.refer_spec.shape[0], dtype=torch.long, device=dev)
        sv = torch.from_numpy(np.repeat(ref.sv_emb[None], b, axis=0)).to(dev) if ref.sv_emb is not None else None
        z, ge = self.s2.decode_latent(
            codes, out.lengths, torch.from_numpy(phones_right(batch, tx_max)).to(dev),
            torch.tensor([len(s["phones"]) for s in batch], dtype=torch.long, device=dev),
            refer_spec, refer_lens, speed=speed, sv_emb=sv,
        )
        wav = self._dec(z.to(self._voc_dtype), g=ge.to(self._voc_dtype))
        return _wav_to_i16(wav), out.lengths

    def _s2_fetch(self, state):
        wav_dev, lengths_dev = state
        wav = wav_dev[..., 0].cpu().numpy()
        lengths = lengths_dev.cpu().numpy()
        hop_up = int(np.prod(self.s2.cfg.upsample_rates))
        return [wav[i, : int(lengths[i]) * 2 * hop_up].astype(np.float32) / 32767.0 for i in range(wav.shape[0])]
