"""The v3 family: S1, the v3 SynthesizerTrnV3 (its int8 DiT CFM on a card,
at v3's 24 kHz mel geometry), BigVGAN-v2 x256 (its anti-aliased snakes
through K6), AP-BWE 24 -> 48 kHz and CNHuBERT.

`build` makes the program's pipeline from a configuration file and the run's
seed; `check` holds a sample of what the window served against the plain
reference (bench_port/reference/voice.py, with reference/bigvgan.py and
reference/apbwe.py in `SRVoiceReference`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from bench_port import traffic
from bench_port.drivers.pipeline import cfm_noise
from bench_port.families.cfm import reading_order
from bench_port.families.vits import table_phones
from bench_port.reference import apbwe, bigvgan, common, dit, hubert, t2s, v3, voice
from bench_port.weights import fill


def build(cfg: dict, seed: int, device):
    """The program's TTSPipeline over a V3Bundle (BigVGAN with its kernel,
    AP-BWE as `sr_model`) with seeded weights, made on `device`, its
    reference (with its transcript) set from the seeded clip."""
    from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline, V3Bundle
    from gpt_sovits_tpu_torch.models.apbwe import APBWEConfig, APNetBWE
    from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
    from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
    from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
    from gpt_sovits_tpu_torch.utils.config import InferenceConfig, MelConfig, S1Config, S2Config

    make = common.make
    with torch.device(device):
        mods = {
            "s1": T2SDecoder(make(S1Config, cfg["s1"])),
            "s2": SynthesizerTrnV3(make(S2Config, cfg["s2"])),
            "hubert": HubertEncoder(make(HubertConfig, cfg["hubert"])),
            "vocoder": BigVGAN(make(BigVGANConfig, cfg["vocoder"]), use_kernel=True),
            "apbwe": APNetBWE(make(APBWEConfig, cfg["apbwe"])),
        }
    for name, m in mods.items():
        fill(m, seed, name, cfg.get("weights"))
    c = cfg["cfm"]
    bundle = V3Bundle(model=mods["s2"], vocoder=mods["vocoder"], mel_cfg=make(MelConfig, cfg["cfm_mel"]),
                      t_ref=c["t_ref"], t_chunk=c["t_chunk"], out_sr=c["out_sr"], sample_steps=c["sample_steps"],
                      overlapped_len=c["overlapped_len"], sr_model=mods["apbwe"])
    serving = cfg["serving"]
    infer = InferenceConfig(repetition_penalty=serving["repetition_penalty"],
                            fragment_interval=serving["fragment_interval"], batch_size=serving["batch_size"])
    pipe = TTSPipeline(s1_model=mods["s1"], s2_model=None, hubert_model=mods["hubert"], v3_bundle=bundle,
                       mel_cfg=make(MelConfig, cfg["mel"]), infer_cfg=infer, device=device)
    ra = cfg["reference_audio"]
    ref_text = traffic.load("sentences_en")["reference_text"]["text"]
    pipe.set_ref_audio(traffic.reference_wav(seed, ra["sr"], ra["seconds"]), sr=ra["sr"], ref_text=ref_text)
    pipe._v3_ref_features()  # what the first request would pay, paid in set-up as set_ref_audio's part
    return pipe


class SRVoiceReference(voice.VoiceReference):
    """The reference of the v3 configuration (or its control): S1, CNHuBERT
    and the v3 synthesizer as `voice.VoiceReference` builds them for v4,
    BigVGAN (reference/bigvgan.py) in place of v4's vocoder, and AP-BWE
    (reference/apbwe.py) as `apbwe`. The control takes BigVGAN to fp8 as
    v4's vocoder (weights and every convolution's input) and runs AP-BWE,
    float32 in the configuration, in TF32 (`check` turns TF32 on around
    it)."""

    def __init__(self, cfg: dict, seed: int, device, *, control: bool = False):
        # voice.VoiceReference.__init__ would build v4's vocoder from cfg["vocoder"]
        self.cfg = cfg
        self.device = dev = torch.device(device)
        self.control = control
        self.family = cfg["family"]
        self.s1cfg = common.make(common.S1Config, cfg["s1"])
        with dev:
            self.s1 = t2s.T2SDecoder(self.s1cfg).eval()
            self.hubert = hubert.HubertEncoder(common.make(hubert.HubertConfig, cfg["hubert"])).eval()
            self.s2 = v3.SynthesizerTrnV3(common.make(common.S2Config, cfg["s2"])).eval()
            self.vocoder = bigvgan.BigVGAN(cfg["vocoder"]).eval()
            self.apbwe = apbwe.APNetBWE(cfg["apbwe"]).eval()
        for name in ("s1", "hubert", "s2", "vocoder", "apbwe"):
            m = getattr(self, name)
            fill(m, seed, name, cfg.get("weights"))
            m.to(dev)  # the buffers made on the host (position tables, windows)
        self.s2.cfm.estimator.to(torch.bfloat16)
        if control:
            voice.s1_to_int4(self.s1)
            dit.lower_precision(self.s2.cfm.estimator, 4)
            voice.to_fp8(self.vocoder)
        else:  # the yardstick of the waveforms' ratio
            self.vocoder_bf16 = copy.deepcopy(self.vocoder).to(torch.bfloat16)
        voice.set_tf32(control)
        self.mel_cfg = common.make(common.MelConfig, cfg["mel"])
        self.serving = cfg.get("serving", {})


def check(cfg: dict, seed: int, device, sample: list, sentences: dict, *, control: bool = False) -> dict:
    """Numbers of the sampled requests against the reference (or, with
    `control`, of the control against the reference): `s1_gap` and
    `mel_err` as the v4 family's (families/cfm.py); `wave_ratio`, the
    largest, over the requests, of the relative L2 distance of the 24 kHz
    int16 audio (the program's AP-BWE inputs, which are BigVGAN and SOLA on
    its own CFM mel, joined as `run` joins segments) from the reference
    BigVGAN's on the program's mel, over that of the reference's own bf16
    BigVGAN; `sr_err`, the largest relative L2 distance of the program's
    AP-BWE output for a segment from the reference AP-BWE's on the same 24
    kHz input (inf where the request's 48 kHz audio is not those outputs
    joined)."""
    ra = cfg["reference_audio"]
    wav = traffic.reference_wav(seed, ra["sr"], ra["seconds"])
    ref_phones = sentences["reference_text"]["phones"]
    ref = SRVoiceReference(cfg, seed, device)
    p = ref.prompt(wav, ra["sr"], ref_phones)
    ctl = SRVoiceReference(cfg, seed, device, control=True) if control else None
    pc = ctl.prompt(wav, ra["sr"], ref_phones) if control else None
    voice.set_tf32(False)
    penalty = cfg["serving"]["repetition_penalty"]
    eos = ref.s1cfg.eos_id
    sr, hr = cfg["cfm"]["out_sr"], cfg["apbwe"]["hr_sampling_rate"]
    gaps, mels, waves, srs, tokens = [], [], [], [], 0
    for rec in sample:
        cap = ref.s1cfg.semantic_frame_rate * rec["max_sec"]
        phones = table_phones(rec, sentences)
        ref_waves, bf16_waves, ctl_waves, prog_waves, prog_hr = {}, {}, {}, {}, {}
        for group in rec["groups"]:
            order = reading_order(rec, sentences, group["phones"])
            if None in order:
                gaps.append(float("inf"))  # the program's frontend did not give the table's phones
                continue
            if rec["sampling"].get("top_k") == 1:
                for pos, toks in zip(order, group["tokens"]):
                    logits = ref.s1_logits(phones[pos], p["codes"], toks)
                    served = torch.as_tensor(np.asarray(toks, np.int64), device=ref.device)
                    if control:
                        voice.set_tf32(True)
                        clog = ctl.s1_logits(phones[pos], pc["codes"], toks)
                        voice.set_tf32(False)
                        g = voice.choice_gaps(logits, clog, p["codes"], served, penalty=penalty, eos=eos)
                    else:
                        g = voice.greedy_gaps(logits, p["codes"], served, penalty=penalty, eos=eos,
                                              capped=len(toks) >= cap)
                    gaps.append(float(g.max()) if g.numel() else 0.0)
                    tokens += len(toks)
            pairs = [(toks, phones[pos]) for pos, toks in zip(order, group["tokens"])]
            noise = cfm_noise(group["mel"].shape, rec["seed"], group["noise_call"], ref.device)
            want, plan = ref.cfm_group(pairs, noise, p)
            if control:
                voice.set_tf32(True)
                got = ctl.cfm_group(pairs, noise, pc)[0]
                voice.set_tf32(False)
            else:
                got = group["mel"][: plan["bs"]].to(ref.device)
            t_min = p["t_min"]
            mels.append(voice.rel_l2(got[:, t_min:].float(), want[:, t_min:].float())
                        if got.shape == want.shape else float("inf"))
            # BigVGAN and SOLA on the program's own mel, judged apart from the CFM stage
            prog_mel, bucket = group["mel"].to(ref.device), group["mel"].shape[0]
            for pos, w in zip(order, ref.vocode_group(prog_mel, plan, bucket, t_min)):
                ref_waves[pos] = w
            for pos, w in zip(order, ref.vocode_group(prog_mel, plan, bucket, t_min, bf16=True)):
                bf16_waves[pos] = w
            if control:
                for pos, w in zip(order, ctl.vocode_group(prog_mel, plan, bucket, t_min)):
                    ctl_waves[pos] = w
            # AP-BWE on the program's own 24 kHz segments, judged apart from the stages before it
            for pos, x, y in zip(order, group["sr_in"], group["sr_out"]):
                prog_waves[pos], prog_hr[pos] = x, y
                want_hr = ref.apbwe.super_resolve(x, sr)
                if control:
                    voice.set_tf32(True)
                    y = ctl.apbwe.super_resolve(x, sr)
                    voice.set_tf32(False)
                srs.append(voice.rel_l2(y.cpu().numpy() if torch.is_tensor(y) else y, want_hr.cpu().numpy()))
        n = len(phones)
        if sorted(ref_waves) != list(range(n)) or sorted(prog_waves) != list(range(n)):
            waves.append(float("inf"))
            srs.append(float("inf"))
            continue
        if not np.array_equal(rec["audio"], ref.join([prog_hr[i] for i in range(n)], hr)):
            srs.append(float("inf"))
        want = ref.join([ref_waves[i] for i in range(n)], sr).astype(np.float64)
        yardstick = voice.rel_l2(ref.join([bf16_waves[i] for i in range(n)], sr).astype(np.float64), want)
        got = ref.join([(ctl_waves if control else prog_waves)[i] for i in range(n)], sr)
        waves.append(voice.rel_l2(got.astype(np.float64), want) / yardstick)
    return {"s1_gap": max(gaps, default=0.0), "mel_err": max(mels, default=0.0), "wave_ratio": max(waves, default=0.0),
            "sr_err": max(srs, default=0.0), "_checked": {"requests": len(sample), "greedy_tokens": tokens}}
