"""The v4 family: S1, the v4 SynthesizerTrnV3 (its int8 DiT CFM on a card),
the x480 vocoder and CNHuBERT.

`build` makes the program's pipeline from a configuration file and the run's
seed; `check` holds a sample of what the window served against the plain
reference (bench_port/reference/voice.py).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port import traffic
from bench_port.drivers.pipeline import cfm_noise
from bench_port.families.vits import table_phones
from bench_port.weights import fill


def build(cfg: dict, seed: int, device):
    """The program's TTSPipeline over a V3Bundle with seeded weights, made on
    `device`, its reference (with its transcript) set from the seeded clip."""
    from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline, V3Bundle
    from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
    from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
    from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
    from gpt_sovits_tpu_torch.models.vits import Generator
    from gpt_sovits_tpu_torch.utils.config import InferenceConfig, MelConfig, S1Config, S2Config

    from bench_port.reference.common import make

    voc = cfg["vocoder"]
    with torch.device(device):
        mods = {
            "s1": T2SDecoder(make(S1Config, cfg["s1"])),
            "s2": SynthesizerTrnV3(make(S2Config, cfg["s2"])),
            "hubert": HubertEncoder(make(HubertConfig, cfg["hubert"])),
            "vocoder": Generator(make(S2Config, voc), in_channels=voc["in_channels"], use_post_bias=True,
                                 conditioned=False),
        }
    for name, m in mods.items():
        fill(m, seed, name, cfg.get("weights"))
    c = cfg["cfm"]
    bundle = V3Bundle(model=mods["s2"], vocoder=mods["vocoder"], mel_cfg=make(MelConfig, cfg["cfm_mel"]),
                      t_ref=c["t_ref"], t_chunk=c["t_chunk"], out_sr=c["out_sr"], sample_steps=c["sample_steps"],
                      overlapped_len=c["overlapped_len"])
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


def reading_order(req: dict, sentences: dict, rows: list) -> list:
    """Where each S1 row (its phones, in the order of the program's batches)
    sits in the request's reading order: the first unused sentence of equal
    phones (a stable sort keeps equal lengths in reading order). None where
    no sentence has the row's phones."""
    want = table_phones(req, sentences)
    used, out = set(), []
    for ph in rows:
        pos = next((i for i, w in enumerate(want) if i not in used and w == list(ph)), None)
        if pos is not None:
            used.add(pos)
        out.append(pos)
    return out


def check(cfg: dict, seed: int, device, sample: list, sentences: dict, *, control: bool = False) -> dict:
    """Numbers of the sampled requests against the reference (or, with
    `control`, of the control against the reference): `s1_gap` as the v2
    family's; `mel_err`, the largest relative L2 distance of a batched CFM
    call's mel (its real chunks, behind the reference window) from the
    reference's (its DiT in bf16: reference/voice.py) on the same noise; `wave_ratio`, the largest, over the
    requests, of the relative L2 distance of the int16 audio from the
    reference vocoder's on the program's mel, over that of the reference's
    own vocoder in bf16 (reference/voice.py)."""
    from bench_port.reference import voice

    ra = cfg["reference_audio"]
    wav = traffic.reference_wav(seed, ra["sr"], ra["seconds"])
    ref_phones = sentences["reference_text"]["phones"]
    ref = voice.VoiceReference(cfg, seed, device)
    p = ref.prompt(wav, ra["sr"], ref_phones)
    ctl = voice.VoiceReference(cfg, seed, device, control=True) if control else None
    pc = ctl.prompt(wav, ra["sr"], ref_phones) if control else None
    voice.set_tf32(False)
    penalty = cfg["serving"]["repetition_penalty"]
    eos = ref.s1cfg.eos_id
    gaps, mels, waves, tokens = [], [], [], 0
    for rec in sample:
        cap = ref.s1cfg.semantic_frame_rate * rec["max_sec"]
        phones = table_phones(rec, sentences)
        ref_waves, bf16_waves, ctl_waves = {}, {}, {}
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
            # the vocoder stage on the program's own mel, judged apart from the CFM stage
            prog_mel, bucket = group["mel"].to(ref.device), group["mel"].shape[0]
            for pos, w in zip(order, ref.vocode_group(prog_mel, plan, bucket, t_min)):
                ref_waves[pos] = w
            for pos, w in zip(order, ref.vocode_group(prog_mel, plan, bucket, t_min, bf16=True)):
                bf16_waves[pos] = w
            if control:
                for pos, w in zip(order, ctl.vocode_group(prog_mel, plan, bucket, t_min)):
                    ctl_waves[pos] = w
        if sorted(ref_waves) != list(range(len(phones))):
            waves.append(float("inf"))
            continue
        sr = cfg["cfm"]["out_sr"]
        want = ref.join([ref_waves[i] for i in range(len(phones))], sr).astype(np.float64)
        yardstick = voice.rel_l2(ref.join([bf16_waves[i] for i in range(len(phones))], sr).astype(np.float64), want)
        got = ctl.join([ctl_waves[i] for i in range(len(phones))], sr) if control else rec["audio"]
        waves.append(voice.rel_l2(got.astype(np.float64), want) / yardstick)
    return {"s1_gap": max(gaps, default=0.0), "mel_err": max(mels, default=0.0), "wave_ratio": max(waves, default=0.0),
            "_checked": {"requests": len(sample), "greedy_tokens": tokens}}
