"""The v2 family (v2ProPlus): S1, the VITS S2 decoder, CNHuBERT and ERes2NetV2.

`build` makes the program's pipeline from a configuration file and the run's
seed; `check` holds a sample of what the window served against the plain
reference (bench_port/reference/voice.py).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port import traffic
from bench_port.weights import fill


def build(cfg: dict, seed: int, device):
    """The program's TTSPipeline with seeded weights, made on `device`, its
    reference set from the seeded clip."""
    from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline
    from gpt_sovits_tpu_torch.models.eres2net import ERes2NetConfig, ERes2NetV2
    from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
    from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
    from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
    from gpt_sovits_tpu_torch.utils.config import InferenceConfig, S1Config, S2Config

    from bench_port.reference.common import make

    with torch.device(device):
        mods = {
            "s1": T2SDecoder(make(S1Config, cfg["s1"])),
            "s2": SynthesizerTrn(make(S2Config, cfg["s2"])),
            "hubert": HubertEncoder(make(HubertConfig, cfg["hubert"])),
            "sv": ERes2NetV2(make(ERes2NetConfig, cfg["sv"])),
        }
    for name, m in mods.items():
        fill(m, seed, name, cfg.get("weights"))
    serving = cfg["serving"]
    infer = InferenceConfig(repetition_penalty=serving["repetition_penalty"],
                            fragment_interval=serving["fragment_interval"])
    pipe = TTSPipeline(s1_model=mods["s1"], s2_model=mods["s2"], hubert_model=mods["hubert"], sv_model=mods["sv"],
                       infer_cfg=infer, device=device)
    ra = cfg["reference_audio"]
    pipe.set_ref_audio(traffic.reference_wav(seed, ra["sr"], ra["seconds"]), sr=ra["sr"])
    return pipe


def table_phones(req: dict, sentences: dict) -> list:
    return [sentences["sentences"][i]["phones"] for i in req["sentences"]]


def check(cfg: dict, seed: int, device, sample: list, sentences: dict, *, control: bool = False) -> dict:
    """Numbers of the sampled requests against the reference (or, with
    `control`, of the control against the reference): `s1_gap`, the widest
    gap of a served greedy token (or the control's choice) below the
    reference's best logit; `wave_ratio`, the largest, over the requests, of
    the relative L2 distance of the int16 audio from the reference's over
    that of the reference's own vocoder in bf16 (reference/voice.py)."""
    from bench_port.reference import voice

    ra = cfg["reference_audio"]
    wav = traffic.reference_wav(seed, ra["sr"], ra["seconds"])
    ref = voice.VoiceReference(cfg, seed, device)
    p = ref.prompt(wav, ra["sr"])
    ctl = voice.VoiceReference(cfg, seed, device, control=True) if control else None
    pc = ctl.prompt(wav, ra["sr"]) if control else None
    voice.set_tf32(False)
    s1c = ref.s1cfg
    cap = cfg["serving"]["max_new"]
    penalty = cfg["serving"]["repetition_penalty"]
    gaps, waves, tokens = [], [], 0
    for rec in sample:
        phones = table_phones(rec, sentences)
        if [list(x) for x in rec["phones"]] != phones:
            gaps.append(float("inf"))  # the program's frontend did not give the table's phones
            continue
        if rec["sampling"].get("top_k") == 1:
            for toks, ph in zip(rec["tokens"], phones):
                logits = ref.s1_logits(ph, p["codes"], toks)
                served = torch.as_tensor(np.asarray(toks, np.int64), device=ref.device)
                if control:
                    voice.set_tf32(True)
                    clog = ctl.s1_logits(ph, pc["codes"], toks)
                    voice.set_tf32(False)
                    g = voice.choice_gaps(logits, clog, p["codes"], served, penalty=penalty, eos=s1c.eos_id)
                else:
                    g = voice.greedy_gaps(logits, p["codes"], served, penalty=penalty, eos=s1c.eos_id,
                                          capped=len(toks) >= cap)
                gaps.append(float(g.max()) if g.numel() else 0.0)
                tokens += len(toks)
        segs = list(zip(rec["tokens"], phones))
        want = ref.vits_request(segs, p).astype(np.float64)
        yardstick = voice.rel_l2(ref.vits_request(segs, p, bf16=True).astype(np.float64), want)
        if control:
            voice.set_tf32(True)
            got = ctl.vits_request(segs, pc)
            voice.set_tf32(False)
        else:
            got = rec["audio"]
        waves.append(voice.rel_l2(got.astype(np.float64), want) / yardstick)
    return {"s1_gap": max(gaps, default=0.0), "wave_ratio": max(waves, default=0.0),
            "_checked": {"requests": len(sample), "greedy_tokens": tokens}}
