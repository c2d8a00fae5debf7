"""On-card smoke test of the PyTorch/CUDA port: builds the CUDA kernels,
holds each against its plain PyTorch twin at the main path's shapes, drives
the full-width v2ProPlus zero-shot pipeline through them, and prints one
JSON line per phase.

    python3 chip_smoke.py            # one CUDA card; exits non-zero on any failure

Phases: device, build, kernels (K1's kernels at L=24, D=512, H=16, F=2048,
T_pad=1024, a live prefix of 745, B in {1, 8}, bf16 and int8/int8;
decode_attn also on a peaked softmax that a masking or fresh-K/V fault
moves far past its bar), widths (the whole step at B = 2..7 in both modes,
held only), path (set_ref_audio + several `run` requests with random
full-width weights made from --seed, launch counts read from the CUDA code),
teacher (a greedy S1 trajectory through the kernels vs the plain twin),
then the `kernels` summary line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Bounds use the H100 SXM's
published peaks (3.35 TB/s; 989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s
f32), with the card's power limit printed beside them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# the port first: without it (the script alone) nothing is printed
from gpt_sovits_tpu_torch import resolve_device
from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline
from gpt_sovits_tpu_torch.models.eres2net import ERes2NetV2
from gpt_sovits_tpu_torch.models.hubert import HubertEncoder
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder, build_prefix_attn_bias
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.ops import build
from gpt_sovits_tpu_torch.ops import decode_step as ds
from gpt_sovits_tpu_torch.utils.config import S1Config, s2_config_for_version

HBM_BYTES_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
L, D, H, F, T_PAD, LIVE = 24, 512, 16, 2048, 1024, 745
KERNEL_SRC = "gpt_sovits_tpu_torch/csrc/decode_step.cu"
REPLACES = "gpt_sovits_tpu/ops/pallas/decode_step.py:361"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean wall time of fn(i) over `iters` back-to-back calls, between CUDA
    events: for these small launches it is the host's enqueue rate."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_events(fn, iters: int, attempts: int = 3):
    """The device kernels of `iters` calls of fn(i) under torch.profiler
    (CUPTI), as key_averages() sums them by name. Now and then the profiler
    returns a window without any device event; such a window is run again,
    up to `attempts` times in all. None if every window came back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        if evs:
            return evs
    return None


def device_ms(fn, iters: int) -> tuple[float, str]:
    """Mean device time of fn(i): the kernels' own busy time, without the
    launch gaps between them, and "profiler". Where the profiler saw no
    device time, the CUDA-event time of the same calls, and "events"."""
    fn(0)
    torch.cuda.synchronize()
    evs = device_events(fn, iters)
    if evs is None:
        return cuda_ms(fn, iters), "events"
    return sum(ev.self_device_time_total for ev in evs) / 1e3 / iters, "profiler"


def timings(prefix: str, fn, iters: int) -> dict:
    ms, timer = device_ms(fn, iters)
    return {f"{prefix}ms": ms, f"{prefix}timer": timer, f"{prefix}wall_ms": cuda_ms(fn, iters)}


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().mean() / (b.float().abs().mean() + 1e-12))


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------


def step_inputs(quant: str, b: int, g: torch.Generator):
    """A full (L, b, T_PAD) cache with a live prefix of LIVE slots and a
    left-padding hole in row 0, and a hidden state x (B, D)."""
    dev = torch.device("cuda")
    kv_f = torch.randn((L, b, T_PAD, 2 * D), generator=g, device=dev) * 0.5
    kv, kv_s = ds.quantize_kv_cache(kv_f) if quant == "int8" else (kv_f.to(torch.bfloat16), None)
    mask = torch.zeros((b, T_PAD), device=dev)
    mask[:, :LIVE] = 1.0
    mask[0, 5:37] = 0.0
    return kv, kv_s, mask, torch.randn((b, D), generator=g, device=dev)


def hold_step(w, quant: str, kv, kv_s, mask, x) -> tuple[float, float]:
    """One step through the kernels and through the twin on the card, each
    on its own copy of the cache: hidden state and the new K/V within the
    JAX tests' bars (bf16: 2e-2 abs; int8: rel 0.02, the probability scale
    being per split). Returns the hidden state's (max abs, mean rel) error."""

    def step(fn):
        return fn(x, w, kv.clone(), mask, LIVE, kv_s.clone() if kv_s is not None else None, num_heads=H)

    def new_kv(out):
        kv_new = out[1][:, :, LIVE].float()
        if quant == "int8":  # dequantize each side with its own per-token scales
            s_new = out[2][:, :, :, LIVE]
            kv_new = torch.cat([kv_new[..., :D] * s_new[:, :, :1], kv_new[..., D:] * s_new[:, :, 1:]], -1)
        return kv_new

    got, ref = step(ds.fused_decode_step), step(ds.fused_decode_step_plain)
    e_abs, e_rel = float((got[0] - ref[0]).abs().max()), rel_err(got[0], ref[0])
    assert (e_rel < 0.02) if quant == "int8" else (e_abs < 2e-2), f"step B={x.shape[0]}: abs {e_abs} rel {e_rel}"
    kv_abs, kv_rel = float((new_kv(got) - new_kv(ref)).abs().max()), rel_err(new_kv(got), new_kv(ref))
    assert (kv_rel < 0.02) if quant == "int8" else (kv_abs < 2e-2), f"new K/V B={x.shape[0]}: abs {kv_abs} rel {kv_rel}"
    return e_abs, e_rel


def _cache(kv_f: torch.Tensor, quant: str):
    """One layer's float K||V (B, T, 2D) as the cache of the given mode."""
    if quant != "int8":
        return kv_f.to(torch.bfloat16), None
    kv, kv_s = ds.quantize_kv_cache(kv_f[None])
    return kv[0], kv_s[0]


def random_attn_inputs(quant: str, b: int, g: torch.Generator):
    """One layer at the random weights' regime: scores of std ~0.25, so the
    softmax over the live prefix is nearly uniform; a hole in row 0."""
    dev = torch.device("cuda")
    qkv = torch.randn((b, 3 * D), generator=g, device=dev) * 0.5
    kv, kv_s = _cache(torch.randn((b, T_PAD, 2 * D), generator=g, device=dev) * 0.5, quant)
    mask = torch.zeros((b, T_PAD), device=dev)
    mask[:, :LIVE] = 1.0
    mask[0, 5:37] = 0.0
    return qkv, kv, kv_s, mask


def peaked_attn_inputs(quant: str, b: int, g: torch.Generator):
    """One layer with a peaked softmax. Per (row, head) the query has norm 4;
    20 keys inside a masked hole (slots 10..29; slots 5..36 are masked in
    every row) score ~9.9 and carry V = +2, so they would take nearly all the
    weight if the mask were ignored; 3 live keys and the fresh key score ~7.1
    against a background of std ~0.35, and the fresh V is -2, so the fresh
    token carries about a fifth of the weight."""
    dev = torch.device("cuda")
    qkv = torch.randn((b, 3 * D), generator=g, device=dev) * 0.5
    u = qkv[:, :D].reshape(b, H, D // H)
    u = (u / u.norm(dim=-1, keepdim=True)).reshape(b, 1, D)
    kv_f = torch.randn((b, T_PAD, 2 * D), generator=g, device=dev) * 0.5
    kv_f[:, 10:30, :D] = 14.0 * u
    kv_f[:, 10:30, D:] = 2.0
    for t in (100, 300, 600):
        kv_f[:, t : t + 1, :D] = 10.0 * u
        kv_f[:, t : t + 1, D:] = torch.randn((b, 1, D), generator=g, device=dev)
    qkv[:, :D] = 4.0 * u[:, 0]
    qkv[:, D : 2 * D] = 10.0 * u[:, 0]
    qkv[:, 2 * D :] = -2.0
    mask = torch.zeros((b, T_PAD), device=dev)
    mask[:, :LIVE] = 1.0
    mask[:, 5:37] = 0.0
    return (qkv, *_cache(kv_f, quant), mask)


def attn_cases(quant: str, b: int, g: torch.Generator) -> dict:
    """decode_attn held against its twin on the random and the peaked inputs.
    bf16: max abs error within 1% of the output's max (probabilities round to
    bf16 per split here and once in the twin, 0.2% of a term at most). int8:
    mean relative error < 0.02, the JAX tests' bar (the probability scale is
    per split here, per VMEM chunk on the TPU)."""
    out = {}
    for case, make in (("random", random_attn_inputs), ("peaked", peaked_attn_inputs)):
        qkv, kv, kv_s, mask = make(quant, b, g)
        got = ds.decode_attn(qkv, kv, kv_s, mask, LIVE, H)
        ref = ds.decode_attn_plain(qkv, kv, kv_s, mask, LIVE, H)
        e_abs, e_rel, top = float((got - ref).abs().max()), rel_err(got, ref), float(ref.abs().max())
        ok = (e_rel < 0.02) if quant == "int8" else (e_abs <= 1e-2 * top)
        out[case] = {"max_abs_err": e_abs, "rel_err": e_rel, "out_max": top, "held": ok}
    assert all(c["held"] for c in out.values()), f"decode_attn {quant} B={b} disagrees with its twin: {out}"
    return out


def kernel_phase(s1_state: dict, quant: str, b: int, seed: int) -> dict:
    """Every K1 kernel at main-path shapes, held against its twin and timed.
    Times are per layer's worth of launches (proj: the 4 projections;
    decode_attn: 1; add_layernorm: 2) and per 24-layer step."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    w = ds.stack_weights_from_params(s1_state, L, quant=quant)
    w = {k: v.to(dev) for k, v in w.items()}
    kv, kv_s, mask, x = step_inputs(quant, b, g)
    xs = {n: torch.randn((b, k), generator=g, device=dev) for n, k in (("qkv", D), ("wo", D), ("fc1", D), ("fc2", F))}
    qkv = torch.randn((b, 3 * D), generator=g, device=dev) * 0.5
    y = torch.randn((b, D), generator=g, device=dev)
    sc = (lambda k, i: w[f"{k}_s"][i]) if quant == "int8" else (lambda k, i: None)
    wname = {"qkv": "wqkv", "wo": "wo", "fc1": "fc1", "fc2": "fc2"}
    bname = {"qkv": "bqkv", "wo": "bo", "fc1": "b1", "fc2": "b2"}
    kind = "int8" if quant == "int8" else "bf16"
    rows = {}

    # proj -------------------------------------------------------------
    def projs(fn, i):
        li = i % L
        return [fn(xs[n], w[wname[n]][li], w[bname[n]][li], sc(wname[n], li), relu=(n == "fc1")) for n in xs]

    err = e_abs = 0.0
    for li in (0, L - 1):
        for got, ref in zip(projs(ds.proj, li), projs(ds.proj_plain, li)):
            e_abs = max(e_abs, float((got - ref).abs().max()))
            err = max(err, float((got - ref).abs().max() / (ref.abs().max() + 1e-12)))
    # the same products summed in another order (f32) or the same int32 sums
    assert err < 1e-3, f"proj disagrees with its twin: {err}"
    nb = sum(w[wname[n]][0].numel() * w[wname[n]].element_size() + w[bname[n]][0].numel() * 4 for n in xs)
    nb += sum(w[f"{wname[n]}_s"][0].numel() * 4 for n in xs) if quant == "int8" else 0
    nb += sum(b * (xs[n].shape[1] + w[wname[n]].shape[-1]) * 4 for n in xs)
    ops = sum(2 * b * w[wname[n]][0].numel() for n in xs)
    lib = None
    if quant == "bf16":
        xb = {n: v.to(torch.bfloat16) for n, v in xs.items()}
        lib = timings("library_", lambda i: [torch.matmul(xb[n], w[wname[n]][i % L]) for n in xs], 48)
    rows["proj"] = dict(max_abs_err=e_abs, max_rel_err=err, **timings("", lambda i: projs(ds.proj, i), 48),
                        **timings("plain_", lambda i: projs(ds.proj_plain, i), 12), **(lib or {"library_ms": None}),
                        bytes=nb, ops=ops, kind=kind)

    # decode_attn ----------------------------------------------------------
    def attn(fn, i):
        li = i % L
        return fn(qkv, kv[li], kv_s[li] if kv_s is not None else None, mask, LIVE, H)

    held = attn_cases(quant, b, g)
    elt = kv.element_size()
    nb = b * LIVE * 2 * D * elt + b * LIVE * 4 + b * 3 * D * 4 + b * D * 4
    nb += b * 2 * LIVE * 4 if quant == "int8" else 0
    ops = 4 * b * H * LIVE * (D // H)
    lib = None
    if quant == "bf16":
        q4 = qkv[:, :D].reshape(b, H, 1, D // H).to(torch.bfloat16)
        kvv = [kv[li, :, :LIVE].view(b, LIVE, 2, H, D // H) for li in range(L)]
        am = (mask[:, None, None, :LIVE] > 0)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = timings("library_", lambda i: sdpa(q4, kvv[i % L][:, :, 0].transpose(1, 2), kvv[i % L][:, :, 1].transpose(1, 2),
                                     attn_mask=am), 48)
    rows["decode_attn"] = dict(max_abs_err=max(c["max_abs_err"] for c in held.values()), held=held,
                               **timings("", lambda i: attn(ds.decode_attn, i), 48),
                               **timings("plain_", lambda i: attn(ds.decode_attn_plain, i), 12),
                               **(lib or {"library_ms": None}),
                               bytes=nb, ops=ops, kind=kind)

    # add_layernorm ----------------------------------------------------------
    def lns(fn, i):
        li = i % L
        return [fn(x, y, w["n1s"][li], w["n1b"][li]), fn(x, y, w["n2s"][li], w["n2b"][li])]

    e = max(float((a - r).abs().max()) for a, r in zip(lns(ds.add_layernorm, 0), lns(ds.add_layernorm_plain, 0)))
    assert e < 1e-4, f"add_layernorm disagrees with its twin: {e}"
    layer_norm = torch.nn.functional.layer_norm
    rows["add_layernorm"] = dict(
        max_abs_err=e, **timings("", lambda i: lns(ds.add_layernorm, i), 48),
        **timings("plain_", lambda i: lns(ds.add_layernorm_plain, i), 48),
        **timings("library_", lambda i: [layer_norm(x + y, (D,), w[s][i % L][0], w[t][i % L][0], 1e-5)
                                         for s, t in (("n1s", "n1b"), ("n2s", "n2b"))], 48),
        bytes=2 * (3 * b * D * 4 + 2 * D * 4), ops=2 * 8 * b * D, kind="f32",
    )

    # the whole step -----------------------------------------------------------
    e_abs, e_rel = hold_step(w, quant, kv, kv_s, mask, x)
    kv_t, s_t = kv.clone(), (kv_s.clone() if kv_s is not None else None)

    def run_step(fn):
        return lambda i: fn(x, w, kv_t, mask, LIVE, s_t, num_heads=H)

    ops = 2 * b * sum(w[k].numel() for k in ("wqkv", "wo", "fc1", "fc2")) + L * 4 * b * H * LIVE * (D // H)
    rows["fused_decode_step"] = dict(
        max_abs_err=e_abs, rel_err=e_rel, **timings("", run_step(ds.fused_decode_step), 10),
        **timings("plain_", run_step(ds.fused_decode_step_plain), 3), library_ms=None,
        bytes=ds.step_bytes(w, kv, LIVE), ops=ops, kind=kind,
    )
    for r in rows.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("bytes"), r.pop("ops"), r.pop("kind"))
    if b == 1:
        emit({"phase": "profile", "mode": f"{quant}/{quant}", "B": b, **profile_steps(run_step(ds.fused_decode_step))})
    return rows


def width_phase(s1_state: dict, seed: int) -> dict:
    """The whole step at every other batch width the path may run (segment
    batches of 2..7 rows), held against the twin, in both modes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}
    for quant in ("bf16", "int8"):
        w = {k: v.to(dev) for k, v in ds.stack_weights_from_params(s1_state, L, quant=quant).items()}
        errs = [hold_step(w, quant, *step_inputs(quant, b, g)) for b in range(2, ds.MAX_ROWS)]
        out[f"{quant}/{quant}"] = {"max_abs_err": max(e for e, _ in errs), "max_rel_err": max(r for _, r in errs)}
    return out


def profile_steps(fn, steps: int = 5) -> dict:
    """Decode steps under torch.profiler: device time per step by kernel
    name, and the share of the (unprofiled) wall time the device sat idle
    (not measured where the profiler saw no device time)."""
    wall = cuda_ms(fn, steps)
    evs = device_events(fn, steps)
    if evs is None:
        return {"wall_ms_per_step": wall, "device_ms_per_step": None, "device_idle_share": None}
    by_name = {
        ev.key[:60]: {"device_ms_per_step": ev.self_device_time_total / 1e3 / steps, "calls_per_step": ev.count / steps}
        for ev in evs
    }
    busy = sum(v["device_ms_per_step"] for v in by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms_per_step"])[:8])
    return {"wall_ms_per_step": wall, "device_ms_per_step": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall), "top_kernels": top}


# ---------------------------------------------------------------------------
# phase: path
# ---------------------------------------------------------------------------


def build_pipeline(seed: int):
    torch.manual_seed(seed)  # random full-width weights, from the seed
    s1 = T2SDecoder(S1Config())
    s2 = SynthesizerTrn(s2_config_for_version("v2ProPlus"))
    hub = HubertEncoder()
    sv = ERes2NetV2()
    return TTSPipeline(s1_model=s1, s2_model=s2, hubert_model=hub, sv_model=sv)


def reference_wav(seed: int, sr: int = 32000, sec: float = 5.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * sec)) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / sr) / k for k in range(1, 8))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t) ** 2
    return (0.2 * voiced * env + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


MAX_SEC = 12  # S1 decode cap per segment: 300 tokens at 25 tokens/s
REQUESTS = [
    "Hello there, this is a short test of the speech pipeline.",
    "The first sentence is short. The second one is a little longer than the first! "
    "And a third sentence closes the request? Yes, it does.",
    "Numbers like 42 and 2024 are read out as words.",
]


def path_phase(pipe, seed: int) -> list[dict]:
    t0 = time.perf_counter()
    pipe.set_ref_audio(reference_wav(seed), sr=32000)
    torch.cuda.synchronize()
    emit({"phase": "path", "event": "set_ref_audio", "s": time.perf_counter() - t0,
          "prompt_tokens": int(len(pipe.ref.prompt_semantic))})
    hop_up = int(np.prod(pipe.s2.cfg.upsample_rates))
    sr = pipe.mel_cfg.sampling_rate
    out = []
    ds.reset_launch_counts()
    for i, text in enumerate(REQUESTS):
        t0 = time.perf_counter()
        sr_out, audio = pipe.run(text, "en", seed=seed + i, max_sec=MAX_SEC)
        wall = time.perf_counter() - t0
        assert sr_out == sr and audio.dtype == np.int16, (sr_out, audio.dtype)
        n_seg = len(pipe.last_tokens)
        expect = sum(n * 2 * hop_up for n in pipe.last_tokens.values()) + (n_seg - 1) * int(sr * pipe.cfg.fragment_interval)
        assert audio.shape == (expect,), (audio.shape, expect)
        assert np.isfinite(audio.astype(np.float32)).all()
        rec = {"phase": "path", "request": i, "segments": n_seg, "tokens": list(pipe.last_tokens.values()),
               "audio_s": len(audio) / sr, "wall_s": wall, "rtf": wall / (len(audio) / sr),
               "phases_s": pipe.last_timing}
        emit(rec)
        out.append(rec)
    assert any(r["segments"] > 1 for r in out), "no request ran a batch of several segments"
    return out


def teacher_phase(pipe, steps: int = 96) -> float:
    """Greedy S1 steps through the kernels and through the twin, both fed
    the kernel trajectory's tokens (bf16 weights and KV). Returns the share
    of steps where the two argmax tokens agree."""
    m = pipe.s1
    dev = pipe.device
    w = {k: v.to(dev) for k, v in ds.stack_weights_from_params(m.state_dict(), L, quant="bf16").items()}
    seg = pipe.preprocess(REQUESTS[0], "en")[0]
    phones = torch.tensor([seg["phones"]], device=dev)
    tx = phones.shape[1]
    prompt = torch.from_numpy(pipe.ref.prompt_semantic[None].astype(np.int64)).to(dev)
    tp = prompt.shape[1]
    t_pad = -(-(tx + tp + steps) // 512) * 512
    with torch.no_grad():
        x_emb = m.embed_text(phones, torch.zeros((1, tx, m.cfg.bert_dim), device=dev), torch.arange(tx, device=dev)[None])
        p_emb = m.embed_audio(prompt, torch.arange(tp, device=dev)[None])
        ones = torch.ones((1, tx), dtype=torch.bool, device=dev)
        _, k, v = m.prefill(torch.cat([x_emb, p_emb], 1), build_prefix_attn_bias(ones, torch.ones((1, tp), dtype=torch.bool, device=dev)))
        kv0 = torch.cat([k.reshape(L, 1, tx + tp, D), v.reshape(L, 1, tx + tp, D)], -1)
        kv0 = torch.nn.functional.pad(kv0, (0, 0, 0, t_pad - tx - tp)).to(torch.bfloat16)
        caches = {"kernel": kv0.clone(), "plain": kv0}
        mask = torch.zeros((1, t_pad), device=dev)
        mask[:, : tx + tp - 1] = 1.0  # the last prompt token attends to its own fresh K/V
        tok_emb = m.embed_audio(prompt[:, -1:], torch.tensor([[tp - 1]], device=dev))
        head = m.ar_predict_layer.weight.float()
        agree = []
        for s in range(steps):
            # step 0 re-feeds the last prompt token into the scratch slot,
            # which the first sampled token then overwrites (as generate())
            widx = tx + tp + max(s - 1, 0)
            yk = ds.fused_decode_step(tok_emb[:, 0].contiguous(), w, caches["kernel"], mask, widx, num_heads=H)[0]
            yp = ds.fused_decode_step_plain(tok_emb[:, 0].contiguous(), w, caches["plain"], mask, widx, num_heads=H)[0]
            lk, lp = yk @ head.t(), yp @ head.t()
            lk[:, m.cfg.eos_id] = lp[:, m.cfg.eos_id] = float("-inf")
            tk = lk.argmax(-1)
            agree.append(bool(tk == lp.argmax(-1)))
            mask[:, tx + tp - 1 if s == 0 else widx] = 1.0
            tok_emb = m.embed_audio(tk[:, None], torch.tensor([[tp + s]], device=dev))
    return float(np.mean(agree))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})

    resolve_device("cuda")
    secs = build.build_all()
    emit({"phase": "build", "s": secs, "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                                                  for k, v in build.BUILD_LOG.items()}})

    torch.manual_seed(args.seed)
    s1_state = T2SDecoder(S1Config()).state_dict()
    table = {}
    for quant in ("bf16", "int8"):
        for b in (1, 8):
            rows = kernel_phase(s1_state, quant, b, args.seed)
            for name, r in rows.items():
                emit({"phase": "kernels", "kernel": name, "mode": f"{quant}/{quant}", "B": b, **r})
            table[(quant, b)] = rows
    emit({"phase": "widths", "B": list(range(2, ds.MAX_ROWS)), **width_phase(s1_state, args.seed)})
    del s1_state
    torch.cuda.empty_cache()

    pipe = build_pipeline(args.seed)
    path_phase(pipe, args.seed)
    launches = ds.launch_counts()  # counted from 0 just before the path's requests
    assert all(n > 0 for n in launches.values()), launches
    agree = teacher_phase(pipe)
    emit({"phase": "teacher", "greedy_agreement": agree})
    assert agree >= 0.9, agree
    emit({"phase": "path", "launches": launches, "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9})

    main_rows = table[("int8", 1)]
    kernels = []
    for name, r in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SRC, "replaces": REPLACES,
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "timer": r["timer"],
            "config": "int8 weights + int8 KV, B=1, live 745 of 1024; proj/add_layernorm/decode_attn per layer, "
                      "fused_decode_step per 24-layer step",
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
