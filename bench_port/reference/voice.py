"""The plain reference of the benchmark's voices: float32 with TF32 off, but
for the v4 CFM's DiT, which runs in bf16 (below).

It builds its own modules (the frozen copies beside this file) from the
configuration file, fills them from the run's seed with the same weight
streams the benchmark gives the program (bench_port/weights.py), and works
out again everything the program derives: the prompt's semantic codes,
the reference spectrogram, the speaker embedding, the timbre, the S1 logits
over the served tokens, S2's waveform, the v4 conditioning, chunk plan and
CFM mel, and the vocoder's waveform. It reads the program's outputs only to
judge them, and the program's CFM mel only to vocode it (the vocoder stage
is judged apart from the CFM stage that feeds it).

`control=True` builds the same reference one precision step below what the
configuration states, the control that the comparison must fail: S1's
int8 layer weights and KV at 4 bits, the DiT's W8A8 block matmuls at W4A4
and its bf16 residual stream in fp8, the bf16 vocoders in fp8 (e4m3,
weights and every convolution's input, one scale a tensor), and the float32
parts in TF32.

The DiT runs in bf16, the precision the configuration states for it outside
its six int8 block matmuls, which run in bf16 here. Against a float32 DiT
the program reads a steady 2.0% on every seed (0.0193-0.0205 relative L2 of
the mel, 15 seeds on the card) that lies in bf16 itself (rotary tables,
probabilities, the residual stream) and hides what the int8 blocks add, and
a control one precision step below reads only 3.0% there.

The vocoders' waveforms are judged by a ratio: the distance of the program's
int16 audio from the float32 reference's over the distance of the same
reference's vocoder run in bf16 (the precision the configuration states)
from it, on the same seed. A random-weight vocoder amplifies rounding by a
factor that changes with the seed (0.006-0.019 in bf16 on six seeds, on the
CPU), and the ratio takes that factor out.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal

from bench_port.reference import common, dit, eres2net, hubert, mel, t2s, v3, vits
from bench_port.reference.precision import fake_quant, fp8
from bench_port.reference.sola import sola_stitch
from bench_port.weights import fill

BS_BUCKETS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32)
EOS_MASK_WARMUP_STEPS = 11  # the reference project's: no EOS before the 11th token


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    g = np.gcd(int(orig_sr), int(target_sr))
    return signal.resample_poly(np.asarray(x, dtype=np.float64), target_sr // g, orig_sr // g).astype(np.float32)


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _fp8_inputs(module, args):
    return (fp8(args[0]),) + tuple(args[1:])


def to_fp8(net: torch.nn.Module) -> None:
    """Weights and every convolution's input of `net` in fp8, in place."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
                m.weight.copy_(fp8(m.weight))
                m.register_forward_pre_hook(_fp8_inputs)


def s1_to_int4(s1: t2s.T2SDecoder) -> None:
    """S1's layer matrices at 4 bits (one scale an output channel) and its
    K/V at 4 bits a token, in place; the head stays float32, as served."""
    with torch.no_grad():
        for layer in s1.h.layers:
            for w in (layer.self_attn.in_proj_weight, layer.self_attn.out_proj.weight, layer.linear1.weight,
                      layer.linear2.weight):
                w.copy_(fake_quant(w, 4, dim=1))
            layer.kv_bits = 4


def presence_rows(prompt: torch.Tensor, served: torch.Tensor, vocab: int, eos: int) -> torch.Tensor:
    """(n + 1, vocab) bool: row j marks the prompt's tokens and served[:j]
    (the repetition penalty's set when token j is drawn), EOS never."""
    n = served.shape[0]
    pres = torch.zeros((n + 1, vocab), dtype=torch.bool, device=served.device)
    pres[:, prompt] = True
    if n:
        seen = F.one_hot(served, vocab).cumsum(0) > 0
        pres[1:] |= seen
    pres[:, eos] = False
    return pres


def penalized(logits: torch.Tensor, presence: torch.Tensor, penalty: float, eos: int) -> torch.Tensor:
    """The logits a greedy row takes its argmax of: the repetition penalty on
    the present tokens, EOS masked at the first EOS_MASK_WARMUP_STEPS
    positions."""
    out = torch.where(presence, torch.where(logits < 0, logits * penalty, logits / penalty), logits)
    early = torch.arange(logits.shape[0], device=logits.device) < EOS_MASK_WARMUP_STEPS
    out[:, eos] = torch.where(early, float("-inf"), out[:, eos])
    return out


def greedy_gaps(logits, prompt, served, *, penalty: float, eos: int, capped: bool) -> torch.Tensor:
    """How far below the reference's best each served greedy token lies, in
    the logits the choice is made on; and, where the row stopped before its
    cap, the same for the EOS that stopped it (the smaller of its gap in the
    plain and in the penalized logits: either ends a row)."""
    n = served.shape[0]
    pen = penalized(logits.float(), presence_rows(prompt, served, logits.shape[1], eos), penalty, eos)
    rows = torch.arange(n, device=logits.device)
    gaps = pen[:n].amax(-1) - pen[rows, served]
    if capped:
        return gaps
    if n < EOS_MASK_WARMUP_STEPS:
        return torch.cat([gaps, torch.full((1,), float("inf"), device=gaps.device)])
    last = logits[n].float()
    stop = torch.minimum(last.amax() - last[eos], pen[n].amax() - pen[n, eos])
    return torch.cat([gaps, stop[None]])


def choice_gaps(ref_logits, ctl_logits, prompt, served, *, penalty: float, eos: int) -> torch.Tensor:
    """At each served position, how far below the reference's best lies the
    token that another computation (the control) would take greedily."""
    n = served.shape[0]
    pres = presence_rows(prompt, served, ref_logits.shape[1], eos)[:n]
    ref = penalized(ref_logits[:n].float(), pres, penalty, eos)
    pick = penalized(ctl_logits[:n].float(), pres, penalty, eos).argmax(-1)
    return ref.amax(-1) - ref[torch.arange(n, device=ref.device), pick]


def rel_l2(a, b) -> float:
    a = torch.as_tensor(np.asarray(a, np.float64) if isinstance(a, np.ndarray) else a).double()
    b = torch.as_tensor(np.asarray(b, np.float64) if isinstance(b, np.ndarray) else b).double()
    if a.shape != b.shape:
        return float("inf")
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def to_int16(wav: torch.Tensor) -> np.ndarray:
    """A [-1, 1] waveform as the pipeline writes int16 (clip, scale, truncate)."""
    return (torch.clamp(wav, -1.0, 1.0).double() * 32767.0).to(torch.int16).cpu().numpy()


def chunk_plan(total_frames: int, chunk_len: int, overlap: int) -> tuple[int, int, int]:
    """(chunks, frames of padding after the last real one, batch bucket) of
    the batched CFM call (the reference project's closed form)."""
    stride = chunk_len - overlap
    bs = max(1, -(-(total_frames + overlap - chunk_len) // stride) + 1)
    padding_len = (bs - 1) * stride + chunk_len - (total_frames + overlap)
    bucket = next(b for b in BS_BUCKETS + (-(-bs // 8) * 8,) if bs <= b)
    return bs, padding_len, bucket


def assemble_chunks(feats, fea_ref0, *, bs: int, overlap: int, chunk_len: int):
    """The conditioning stream (1, T, C) front-padded by the overlap, cut in
    `bs` overlapping windows, each behind the reference window (1, Tr, C)."""
    stride = chunk_len - overlap
    f = F.pad(feats[0], (0, 0, overlap, 0))
    need = (bs - 1) * stride + chunk_len
    if need > f.shape[0]:
        f = F.pad(f, (0, 0, 0, need - f.shape[0]))
    chunks = torch.stack([f[i * stride : i * stride + chunk_len] for i in range(bs)])
    return torch.cat([fea_ref0.expand(bs, -1, -1), chunks], dim=1)


class VoiceReference:
    """The reference (or its control) of one configuration at one seed."""

    def __init__(self, cfg: dict, seed: int, device, *, control: bool = False):
        self.cfg = cfg
        self.device = dev = torch.device(device)
        self.control = control
        self.family = cfg["family"]
        spec = cfg.get("weights")
        self.s1cfg = common.make(common.S1Config, cfg["s1"])
        s2cfg = common.make(common.S2Config, cfg["s2"])
        with dev:
            self.s1 = t2s.T2SDecoder(self.s1cfg).eval()
            self.hubert = hubert.HubertEncoder(common.make(hubert.HubertConfig, cfg["hubert"])).eval()
            if self.family == "vits":
                self.s2 = vits.SynthesizerTrn(s2cfg).eval()
                self.sv = eres2net.ERes2NetV2(common.make(eres2net.ERes2NetConfig, cfg["sv"])).eval()
            else:
                self.s2 = v3.SynthesizerTrnV3(s2cfg).eval()
                voc = cfg["vocoder"]
                self.vocoder = vits.Generator(common.make(common.S2Config, voc), in_channels=voc["in_channels"],
                                              use_post_bias=True, conditioned=False).eval()
        fill(self.s1, seed, "s1", spec)
        fill(self.hubert, seed, "hubert", spec)
        fill(self.s2, seed, "s2", spec)
        if self.family == "vits":
            fill(self.sv, seed, "sv", spec)
        else:
            fill(self.vocoder, seed, "vocoder", spec)
        for m in self.modules():
            m.to(dev)  # the buffers made on the host (position tables, windows)
        if self.family == "cfm":
            self.s2.cfm.estimator.to(torch.bfloat16)
        if control:
            s1_to_int4(self.s1)
            if self.family == "vits":
                to_fp8(self.s2.dec)
            else:
                dit.lower_precision(self.s2.cfm.estimator, 4)
                to_fp8(self.vocoder)
        set_tf32(control)
        if not control:  # the yardstick of the waveforms' ratio
            self.vocoder_bf16 = copy.deepcopy(self.s2.dec if self.family == "vits" else self.vocoder).to(torch.bfloat16)
        self.mel_cfg = common.make(common.MelConfig, cfg["mel"])
        self.serving = cfg.get("serving", {})

    def modules(self) -> list:
        return [m for m in (self.s1, self.hubert, self.s2, getattr(self, "sv", None), getattr(self, "vocoder", None))
                if m is not None]

    # -- the reference audio ----------------------------------------------

    @torch.no_grad()
    def prompt(self, wav: np.ndarray, sr: int, ref_phones=None) -> dict:
        """What the program's set_ref_audio derives: the prompt's semantic
        codes, the reference spectrogram, the speaker embedding (v2Pro
        family) and, for v4, the prompt's conditioning and mel window."""
        dev = self.device
        wav16 = np.concatenate([resample(wav, sr, 16000), np.zeros(int(16000 * 0.3), np.float32)])
        ssl = self.hubert(torch.from_numpy(wav16[None]).to(dev))
        codes = self.s2.extract_latent(ssl)[0]
        native = resample(wav, sr, self.mel_cfg.sampling_rate)
        peak = float(np.abs(native).max())
        if peak > 1.0:
            native = native / min(2.0, peak)
        spec = mel.spectrogram(torch.from_numpy(native[None]).to(dev), self.mel_cfg)[0].T
        out = {"codes": codes, "spec": spec, "sv": None}
        if self.family == "vits":
            if self.s2.cfg.is_pro:
                wav16b = resample(native, self.mel_cfg.sampling_rate, 16000)
                out["sv"] = self.sv(eres2net.kaldi_fbank(torch.from_numpy(wav16b[None]).to(dev)))[0]
            return out
        c = self.cfg["cfm"]
        ids = torch.tensor([ref_phones], dtype=torch.long, device=dev)
        fea_ref, ge, _ = self.s2.decode_encp(codes[None], torch.tensor([codes.shape[0]], device=dev), ids,
                                             torch.tensor([ids.shape[1]], device=dev), spec[None],
                                             torch.tensor([spec.shape[0]], device=dev))
        cfm_mel = common.make(common.MelConfig, self.cfg["cfm_mel"])
        wav_t = resample(wav, sr, cfm_mel.sampling_rate)
        mel2 = mel.norm_spec(mel.mel_spectrogram(torch.from_numpy(wav_t[None]).to(dev), cfm_mel)).transpose(1, 2)
        t_min = min(mel2.shape[1], fea_ref.shape[1])
        mel2, fea_ref = mel2[:, :t_min], fea_ref[:, :t_min]
        if t_min > c["t_ref"]:
            mel2, fea_ref, t_min = mel2[:, -c["t_ref"]:], fea_ref[:, -c["t_ref"]:], c["t_ref"]
        out.update(fea_ref=fea_ref, ge=ge, mel2=mel2, t_min=t_min)
        return out

    # -- S1 ------------------------------------------------------------------

    @torch.no_grad()
    def s1_logits(self, phones, prompt_codes: torch.Tensor, served: np.ndarray) -> torch.Tensor:
        """(n + 1, vocab): the logits that predicted served[0..n-1] and the
        token after them."""
        dev = self.device
        sem = torch.cat([prompt_codes.long(), torch.as_tensor(np.asarray(served, np.int64), device=dev)])
        return self.s1.logits(torch.tensor(phones, dtype=torch.long, device=dev), sem)[-(len(served) + 1):]

    # -- v2 family: S2 -------------------------------------------------------

    @torch.no_grad()
    def vits_segment(self, tokens: np.ndarray, phones, p: dict, bf16: bool = False) -> torch.Tensor:
        """One segment's waveform (samples,) in [-1, 1]: decode_latent and
        the generator (its bf16 copy with `bf16`)."""
        dev = self.device
        codes = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)[None]
        text = torch.tensor([phones], dtype=torch.long, device=dev)
        spec = p["spec"][None]
        sv = None if p["sv"] is None else p["sv"][None]
        z, ge = self.s2.decode_latent(codes, torch.tensor([codes.shape[1]], device=dev), text,
                                      torch.tensor([text.shape[1]], device=dev), spec,
                                      torch.tensor([spec.shape[1]], device=dev), sv_emb=sv)
        if bf16:
            return self.vocoder_bf16(z.to(torch.bfloat16), g=ge.to(torch.bfloat16)).float()[0, :, 0]
        return self.s2.dec(z, g=ge)[0, :, 0]

    def vits_request(self, segments: list, p: dict, bf16: bool = False) -> np.ndarray:
        """A request's int16 audio: its segments (tokens, phones) in reading
        order, joined by the inter-fragment silence."""
        sr = self.mel_cfg.sampling_rate
        silence = np.zeros(int(sr * self.serving["fragment_interval"]), np.int16)
        pieces = []
        for tokens, phones in segments:
            pieces += [to_int16(self.vits_segment(tokens, phones, p, bf16)), silence]
        return np.concatenate(pieces[:-1])

    # -- v4: the CFM path ----------------------------------------------------

    @torch.no_grad()
    def cfm_group(self, segments: list, noise: torch.Tensor, p: dict) -> tuple[torch.Tensor, dict]:
        """One batched CFM call of the pipeline: the segments (tokens, phones)
        of one S1 batch, in its order -> the mel (bf16) of the real chunks
        (bs, T, M) behind the reference window, and the plan (bs, padding_len, chunk_len,
        frames a segment). `noise` is the call's initial noise (the same the
        program was given)."""
        dev = self.device
        c = self.cfg["cfm"]
        t_min = p["t_min"]
        chunk_len = c["t_chunk"] - t_min
        feats, lens = [], []
        for tokens, phones in segments:
            n = len(tokens)
            ids = torch.tensor([phones], dtype=torch.long, device=dev)
            fea, _, mel_len = self.s2.decode_encp(
                torch.as_tensor(np.asarray(tokens, np.int64), device=dev)[None], torch.tensor([n], device=dev), ids,
                torch.tensor([ids.shape[1]], device=dev), p["spec"][None], torch.tensor([p["spec"].shape[0]], device=dev),
                ge=p["ge"])
            total = int(mel_len[0])
            feats.append(fea[:, :total])
            lens.append(total)
        bs, padding_len, _ = chunk_plan(sum(lens), chunk_len, c["overlapped_len"])
        fea = assemble_chunks(torch.cat(feats, dim=1), p["fea_ref"], bs=bs, overlap=c["overlapped_len"],
                              chunk_len=chunk_len)
        mel_out = v3.cfm_inference(self.s2.cfm.estimator, fea.to(torch.bfloat16),
                                   torch.full((bs,), t_min + chunk_len, device=dev),
                                   p["mel2"].expand(bs, -1, -1), noise=noise[:bs], n_steps=c["sample_steps"])
        plan = {"bs": bs, "padding_len": padding_len, "chunk_len": chunk_len, "lens": lens}
        return mel_out, plan

    @torch.no_grad()
    def vocode_group(self, cfm_out: torch.Tensor, plan: dict, bucket: int, t_min: int, bf16: bool = False) -> list:
        """The vocoder stage of one batched call on a CFM output (bucket, T,
        M) (the program's, so that this stage is judged alone): the real
        chunks as one mel, the bucket's pad chunks holding the last real
        frame, one vocoder call (its bf16 copy with `bf16`), int16, the SOLA
        stitch -> each segment's float waveform."""
        c = self.cfg["cfm"]
        bs, chunk_len = plan["bs"], plan["chunk_len"]
        overlap = c["overlapped_len"]
        up = c["out_sr"] * self.cfg["cfm_mel"]["hop_size"] // self.cfg["cfm_mel"]["sampling_rate"]
        mel_long = cfm_out[:bs, t_min:].float().reshape(1, bs * chunk_len, -1)
        if bucket > bs:
            mel_long = torch.cat([mel_long, mel_long[:, -1:].expand(1, (bucket - bs) * chunk_len, -1)], dim=1)
        x = mel.denorm_spec(mel_long)
        y = self.vocoder_bf16(x.to(torch.bfloat16)).float() if bf16 else self.vocoder(x)
        wav = to_int16(y[0, : bs * chunk_len * up, 0])
        wav = wav.astype(np.float32) / 32767.0
        frag = chunk_len * up
        audio = sola_stitch([wav[k * frag : (k + 1) * frag] for k in range(bs)], overlap * up)
        audio = audio[overlap * up : len(audio) - plan["padding_len"] * up or None]
        out, off = [], 0
        for total in plan["lens"]:
            out.append(audio[off : off + total * up])
            off += total * up
        return out

    def join(self, waves: list, sr: int) -> np.ndarray:
        """Segment waveforms in reading order -> the request's int16 audio."""
        silence = np.zeros(int(sr * self.serving["fragment_interval"]), np.float32)
        pieces = []
        for w in waves:
            pieces += [w, silence]
        return (np.clip(np.concatenate(pieces[:-1]), -1.0, 1.0) * 32767.0).astype(np.int16)
