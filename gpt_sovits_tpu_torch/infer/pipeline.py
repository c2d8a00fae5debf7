"""Zero-shot TTS pipeline, v2 family and v4 (port of
gpt_sovits_tpu/infer/pipeline.py: `TTSPipeline.set_ref_audio` + `run`).

  * set_ref_audio: reference wav -> 16 kHz CNHuBERT features -> VQ prompt
    semantic tokens; linear spectrogram for timbre; v2Pro/v2ProPlus also
    the ERes2NetV2 speaker embedding of the 16 kHz audio
  * preprocess: cut method -> g2p -> phone ids (English; BERT features are
    zeros for every non-zh language, so BERT is not on this path)
  * run: length-sorted greedy bucketing, batched S1 decode, one S2 decode
    per bucket, inter-fragment silence, original order restored, int16

v3/v4 (a `V3Bundle`): S1 as above, then per segment `decode_encp`, all
segments' conditioning cut into overlapping chunks behind the reference
window, ONE batched CFM call over the chunks, ONE vocoder call, and a SOLA
stitch (the default batched branch, pipeline.py:1037-1138). Only v4's
HiFiGAN vocoder is ported; v3's BigVGAN, AP-BWE, the serial branch and
streaming raise NotImplementedError (ROADMAP.md, slice 3).

On a GPU the S1 step runs the CUDA kernels of ops/decode_step.py (int8
weights and int8 KV by default, as the JAX package on an accelerator), the
vocoder runs in bf16, and the v4 CFM runs in bf16 with the int8 DiT (the
CUDA kernels of ops/qmatmul.py and ops/qflash.py), T padded to a multiple
of 512; on the CPU the DiT stays float and T unpadded, as in the JAX
package. The JAX package's TPU devices (compile-cache
buckets for padded shapes, the lane-folded vocoder, the cross-group
launch/fetch overlap over a slow host link) have no counterpart here; the
padded shapes are kept so that both packages run the same computation.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Optional

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from gpt_sovits_tpu_torch import resolve_device
from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, resample
from gpt_sovits_tpu_torch.dsp.mel import denorm_spec, mel_spectrogram, norm_spec, spectrogram
from gpt_sovits_tpu_torch.dsp.sola import sola_stitch
from gpt_sovits_tpu_torch.models.dit import serving_dit
from gpt_sovits_tpu_torch.models.eres2net import kaldi_fbank
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder, generate
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3, cfm_inference
from gpt_sovits_tpu_torch.models.vits import Generator, SynthesizerTrn
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


# chunk-batch buckets of the batched v3/v4 CFM + vocoder call (the JAX
# package's compile-cache buckets, kept so both run the same shapes)
_BS_BUCKETS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32)


def _next_bs_bucket(n: int) -> int:
    for b in _BS_BUCKETS:
        if n <= b:
            return b
    return -(-n // 8) * 8


def _v3_assemble_chunks(feats, fea_ref0, *, bs: int, bs_pad: int, overlap: int, chunk_len: int):
    """Front-pad the conditioning stream (1, T, C) by the SOLA overlap, cut
    `bs` windows of `chunk_len` overlapping by `overlap`, pad the batch to
    `bs_pad`, and put the reference window (1, Tr, C) before every row
    (TTS.py:1553-1575) -> (bs_pad, Tr + chunk_len, C)."""
    stride = chunk_len - overlap
    f = F.pad(feats[0], (0, 0, overlap, 0))
    need = (bs - 1) * stride + chunk_len
    if need > f.shape[0]:
        f = F.pad(f, (0, 0, 0, need - f.shape[0]))
    chunks = torch.stack([f[i * stride : i * stride + chunk_len] for i in range(bs)])
    if bs_pad > bs:
        chunks = F.pad(chunks, (0, 0, 0, 0, 0, bs_pad - bs))
    return torch.cat([fea_ref0.expand(bs_pad, -1, -1), chunks], dim=1)


def v3_chunk_plan(total_frames: int, chunk_len: int, overlap: int) -> tuple[int, int, int]:
    """(bs, padding_len, bs_pad): the number of overlapping chunks that
    cover `total_frames` behind an `overlap` front pad, the frames of
    padding after the last real one, and the batch bucket. The JAX
    package's closed form (pipeline.py:1075-1089), which at a few lengths
    saves the reference loop's extra chunk of only duplicated overlap."""
    stride = chunk_len - overlap
    bs = max(1, -(-(total_frames + overlap - chunk_len) // stride) + 1)
    padding_len = (bs - 1) * stride + chunk_len - (total_frames + overlap)
    return bs, padding_len, _next_bs_bucket(bs)


def serving_t_chunk(version: str, device) -> int:
    """CFM window length: the reference's 934 (v3) / 1000 (v4) frames on the
    CPU; 1024 on a card, where the DiT pads every chunk to a multiple of 512
    anyway (utils/loaders.py `_serving_t_chunk`)."""
    return 1024 if torch.device(device).type == "cuda" else (934 if version == "v3" else 1000)


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
    prompt_phones: Optional[list] = None  # phone ids of the reference text (v3/v4)
    raw_wav: Optional[np.ndarray] = None  # the reference as given, for the v3/v4 prompt mel
    raw_sr: int = 0


@dataclasses.dataclass
class V3Bundle:
    """Models and constants of the v3/v4 CFM path (TTS.py init_vocoder,
    :601-660). The port serves v4: `vocoder` is the x480 HiFiGAN
    `Generator` (weights loaded); v3's BigVGAN and the AP-BWE `sr_model`
    wait for slice 3."""

    model: SynthesizerTrnV3
    vocoder: Any
    mel_cfg: MelConfig  # MEL_V4 (or MEL_V3)
    t_ref: int  # 500 (v4) / 468 (v3)
    t_chunk: int  # serving_t_chunk(): 1024 on a card, 1000 (v4) on the CPU
    out_sr: int  # 48000 (v4) / 24000 (v3)
    sample_steps: int = 32
    overlapped_len: int = 12  # SOLA overlap in mel frames (TTS.py:621,654)
    sr_model: Any = None


class TTSPipeline:
    def __init__(
        self,
        *,
        s1_model: T2SDecoder,
        s2_model: Optional[SynthesizerTrn],
        hubert_model,
        sv_model=None,
        mel_cfg: MelConfig = MelConfig(),
        infer_cfg: InferenceConfig = InferenceConfig(),
        v3_bundle: Optional[V3Bundle] = None,  # v4: the CFM path replaces S2 (s2_model may be None)
        use_fused_s1: Optional[bool] = None,  # default: on for a GPU
        s1_weight_quant: Optional[str] = None,  # "int8" | "bf16"; default int8 on a GPU
        s1_kv_quant: Optional[str] = None,  # "int8" | "bf16"; default int8 on a GPU
        half: Optional[bool] = None,  # bf16 vocoder (and v4 CFM + int8 DiT); default on a GPU
        device=None,  # None: CUDA (raises without a card); "cpu" for the tests
    ):
        self.device = resolve_device(device)
        on_gpu = self.device.type == "cuda"
        self.s1 = s1_model.to(self.device).eval()
        self.s2 = s2_model.to(self.device).eval() if s2_model is not None else None
        self.hubert = hubert_model.to(self.device).eval()
        self.sv = sv_model.to(self.device).eval() if sv_model is not None else None
        self.mel_cfg = mel_cfg
        self.cfg = infer_cfg
        self.v3 = v3_bundle
        if v3_bundle is not None:
            self.version = v3_bundle.model.cfg.version
        elif s2_model is not None:
            self.version = s2_model.cfg.version
            if self.version not in ("v1", "v2", "v2Pro", "v2ProPlus"):
                raise NotImplementedError(f"S2 version {self.version} is served through a V3Bundle")
        else:
            raise ValueError("an S2 model or a V3Bundle is required")
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
        if self.v3 is None:
            self._dec = copy.deepcopy(self.s2.dec).to(self._voc_dtype) if self.half else self.s2.dec
        else:
            self._init_v3(on_gpu)
        self.meter = ThroughputMeter()
        self.last_timing: dict = {}

    def _init_v3(self, on_gpu: bool):
        """The v4 serving state (pipeline.py:302-375): the vocoder in the
        vocoder dtype; the DiT cast to the CFM dtype and, on a card with
        half, quantized to int8 after the cast."""
        v3 = self.v3
        if not isinstance(v3.vocoder, Generator):
            raise NotImplementedError(
                "only the v4 HiFiGAN vocoder is ported; v3's BigVGAN is slice 3 (ROADMAP.md queue 1)")
        if v3.sr_model is not None:
            raise NotImplementedError("AP-BWE super-resolution is slice 3 (ROADMAP.md queue 1)")
        v3.model.to(self.device).eval()
        voc = v3.vocoder.to(self.device).eval()
        self._voc = copy.deepcopy(voc).to(self._voc_dtype) if self.half else voc
        self.dit_quant = "int8" if on_gpu and self.half else "bf16"
        self._cfm_dtype = torch.bfloat16 if self.half else torch.float32
        self._dit = serving_dit(v3.model.cfm.estimator.state_dict(), v3.model.dit_config, self._cfm_dtype,
                                self.dit_quant)
        self._dit.to(self.device)
        self.pad_t_to = 512 if on_gpu else 0
        self._fea_ref_cache = None
        self.last_cfm_batch: list = []

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
        if self.s2 is not None and self.s2.cfg.is_pro and self.sv is not None:
            wav16 = resample(wav_native, sr_native, 16000)
            feat = kaldi_fbank(torch.from_numpy(wav16[None]).to(self.device))
            sv_emb = self.sv(feat)[0].float().cpu().numpy()
        return spec.float().cpu().numpy(), sv_emb

    @torch.no_grad()
    def set_ref_audio(self, wav, sr: Optional[int] = None, ref_text: Optional[str] = None, ref_lang: str = "en"):
        """wav: path or float array. Extracts and caches prompt features;
        v3/v4 also need the reference's transcript `ref_text`."""
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
        codes = (self.v3.model if self.v3 is not None else self.s2).extract_latent(ssl)
        spec, sv_emb = self._ref_spec_sv(wav, sr)
        self.ref = RefCache(prompt_semantic=codes[0].cpu().numpy(), refer_spec=spec, sv_emb=sv_emb,
                            raw_wav=np.asarray(wav, np.float32), raw_sr=sr)
        if ref_text:
            self.ref.prompt_phones = self._g2p_segment(ref_text, ref_lang)[0]
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
        sample_steps: Optional[int] = None,  # v3/v4 CFM Euler steps
        early_stop_num: Optional[int] = None,
    ) -> tuple[int, np.ndarray]:
        """Synthesize. Returns (sample_rate, int16 waveform). Phases in
        `last_timing`: preprocess, s1, s2 (v2 family) or preprocess, s1, cfm,
        vocoder (v4), each closed by a device sync."""
        if self.ref is None:
            raise RuntimeError("call set_ref_audio first")
        if self.v3 is not None and not parallel_infer:
            raise NotImplementedError("the serial v3/v4 branch (parallel_infer=False) is slice 3 (ROADMAP.md queue 1)")
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
        if self.v3 is not None:
            self.last_cfm_batch = []
        for group in groups:
            idx = [order[g] for g in group]
            batch = [segments[i] for i in idx]
            with timer.phase("s1"):
                s1 = self._s1_launch(batch, gen, **s1_kw)
                lengths = s1[0].lengths.tolist()  # host read: S1 is done
            if self.v3 is not None:
                with timer.phase("cfm"):
                    state = self._v3_cfm(batch, s1, gen, speed=speed, sample_steps=sample_steps)
                    self._sync()
                with timer.phase("vocoder"):
                    out = self._v3_fetch(self._v3_vocode(state))
            else:
                with timer.phase("s2"):
                    out = self._s2_fetch(self._s2_launch(batch, s1, max(lengths), speed=speed))
            for i, w in zip(idx, out):
                wavs[i] = w
            self.last_tokens.update(zip(idx, lengths))

        sr = self.mel_cfg.sampling_rate if self.v3 is None else self.v3.out_sr
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

    def run_streaming(self, text: str, language: str = "en", **kwargs):
        """Fragments as they are ready: not ported yet (ROADMAP.md queue 1,
        slice 3)."""
        raise NotImplementedError("run_streaming is slice 3 (ROADMAP.md queue 1)")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

    # ------------------------------------------------------------------
    # v3/v4: batched chunked CFM + one vocoder call (pipeline.py:923-1138)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _v3_ref_features(self):
        """(fea_ref (1, T, 512), ge (1, 1, gin), normalized prompt mel
        (1, T, mel), T) of the current reference, cached per reference."""
        ref = self.ref
        if self._fea_ref_cache is not None and self._fea_ref_cache[0] is ref:
            return self._fea_ref_cache[1]
        v3 = self.v3
        if not ref.prompt_phones:
            raise ValueError("v3/v4 synthesis requires reference text (set_ref_audio(..., ref_text=...))")
        dev = self.device
        codes = torch.from_numpy(ref.prompt_semantic[None].astype(np.int64)).to(dev)
        ids = torch.tensor([ref.prompt_phones], dtype=torch.long, device=dev)
        fea_ref, ge, _ = v3.model.decode_encp(
            codes, torch.tensor([codes.shape[1]], device=dev), ids, torch.tensor([ids.shape[1]], device=dev),
            torch.from_numpy(ref.refer_spec[None]).to(dev), torch.tensor([ref.refer_spec.shape[0]], device=dev),
        )
        wav_t = resample(ref.raw_wav, ref.raw_sr, v3.mel_cfg.sampling_rate)
        mel2 = norm_spec(mel_spectrogram(torch.from_numpy(wav_t[None]).to(dev), v3.mel_cfg)).transpose(1, 2)
        t_min = min(mel2.shape[1], fea_ref.shape[1])
        mel2, fea_ref = mel2[:, :t_min], fea_ref[:, :t_min]
        if t_min > v3.t_ref:
            mel2, fea_ref = mel2[:, -v3.t_ref :], fea_ref[:, -v3.t_ref :]
            t_min = v3.t_ref
        feats = (fea_ref, ge, mel2, t_min)
        self._fea_ref_cache = (ref, feats)
        return feats

    def _mel_len_for(self, n_tokens: int, speed: float) -> int:
        """Host twin of decode_encp's mel_len: nominal frames clamped to the
        interpolated content length."""
        v3 = self.v3.model.cfg.version == "v3"
        f = np.float32(3.875 if v3 else 4)
        interp = np.float32(1.875 if v3 else 2.0)
        if speed != 1.0:
            ml = int(np.float32(n_tokens) * f / np.float32(speed)) + 1
        else:
            ml = int(np.float32(n_tokens) * f)
        return min(ml, int(np.floor(np.float32(n_tokens * 2) * interp)))

    def _cfm_noise(self, shape, generator) -> torch.Tensor:
        """The CFM's initial noise, f32 (the tests feed the JAX package's
        draws here)."""
        return torch.randn(shape, generator=generator, device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def _v3_cfm(self, batch, s1_state, generator, *, speed, sample_steps=None):
        """The launch stage's first half (`_v3_launch`, pipeline.py:1037-1100):
        every segment's conditioning, one stream cut into overlapping chunks,
        one batched CFM call -> the state `_v3_vocode` takes."""
        v3 = self.v3
        out, _ = s1_state
        lengths = out.lengths.tolist()
        fea_ref0, ge, mel2_0, t_min = self._v3_ref_features()
        upsample = v3.out_sr * v3.mel_cfg.hop_size // v3.mel_cfg.sampling_rate
        chunk_len = v3.t_chunk - t_min
        overlap = v3.overlapped_len
        dev = self.device
        refer = torch.from_numpy(self.ref.refer_spec[None]).to(dev)
        refer_len = torch.tensor([refer.shape[1]], device=dev)
        feat_list, feat_lens = [], []
        for i, seg in enumerate(batch):
            n = int(lengths[i])
            pids = torch.tensor([seg["phones"]], dtype=torch.long, device=dev)
            fea, _, _ = v3.model.decode_encp(
                out.tokens[i : i + 1, : _next_bucket(n)], torch.tensor([n], device=dev), pids,
                torch.tensor([pids.shape[1]], device=dev), refer, refer_len, speed=speed, ge=ge,
            )
            total = self._mel_len_for(n, speed)
            feat_list.append(fea[:, :total])
            feat_lens.append(total)
        feats = torch.cat(feat_list, dim=1)
        bs, padding_len, bs_pad = v3_chunk_plan(sum(feat_lens), chunk_len, overlap)
        fea = _v3_assemble_chunks(feats, fea_ref0, bs=bs, bs_pad=bs_pad, overlap=overlap, chunk_len=chunk_len)
        noise = self._cfm_noise((bs_pad, fea.shape[1], mel2_0.shape[2]), generator)
        mel_out = cfm_inference(
            self._dit, fea.to(self._cfm_dtype), torch.full((bs_pad,), t_min + chunk_len, device=dev),
            mel2_0.expand(bs_pad, -1, -1), noise=noise, n_steps=int(sample_steps or v3.sample_steps),
            pad_t_to=self.pad_t_to,
        ).float()
        self.last_cfm_batch.append((bs, bs_pad))
        # (bs_pad, t_min + chunk_len, M) -> one long mel; the bucket's pad rows
        # hold the last real frame so they do not touch the last real chunk
        mel_long = mel_out[:bs, t_min:].reshape(1, bs * chunk_len, -1)
        if bs_pad > bs:
            mel_long = torch.cat([mel_long, mel_long[:, -1:].expand(1, (bs_pad - bs) * chunk_len, -1)], dim=1)
        return mel_long, feat_lens, bs, padding_len, chunk_len, overlap, upsample

    @torch.no_grad()
    def _v3_vocode(self, state):
        """The launch stage's second half (pipeline.py:1101-1111): one
        vocoder call, int16 on the device, cut to the real chunks."""
        mel_long, feat_lens, bs, padding_len, chunk_len, overlap, upsample = state
        wav = _wav_to_i16(self._voc(denorm_spec(mel_long).to(self._voc_dtype)))[0, : bs * chunk_len * upsample, 0]
        return wav, feat_lens, bs, padding_len, chunk_len, overlap, upsample

    def _v3_fetch(self, state):
        """Fetch stage: int16 off the device, SOLA crossfade, one clip per
        segment."""
        wav_dev, feat_lens, bs, padding_len, chunk_len, overlap, upsample = state
        wav = wav_dev.cpu().numpy().astype(np.float32) / 32767.0
        frag_len = chunk_len * upsample
        audio = sola_stitch([wav[k * frag_len : (k + 1) * frag_len] for k in range(bs)], overlap * upsample)
        audio = audio[overlap * upsample : len(audio) - padding_len * upsample or None]
        out, off = [], 0
        for total in feat_lens:
            out.append(audio[off : off + total * upsample])
            off += total * upsample
        return out
