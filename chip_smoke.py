"""On-card smoke test of the PyTorch/CUDA port: builds the CUDA kernels,
holds each against its plain PyTorch twin at the main path's shapes, drives
the full-width v2ProPlus (English, and zh/auto with BERT features), v4 and
v3 zero-shot pipelines through them, and prints one JSON line per phase.

    python3 chip_smoke.py            # one CUDA card; exits non-zero on any failure
    python3 chip_smoke.py --parent smoke_tree/parent   # also time K1-K6 on an earlier tree's kernels

Phases: device, build, kernels (K1 at L=24, D=512, H=16, F=2048, T_pad=1024,
a live prefix of 745, B in {1, 8}, bf16 and int8/int8: the whole-step kernel
on random inputs and on a step whose layer-0 attention is peaked on the
fresh token with large keys in a masked hole, step_cases), widths (the
whole step at B = 2..7 in both modes, random and peaked, held only; at the
longest prefix it takes; at B = 2 and 4 with one write slot a row,
rows at different steps, rowwise_cases; at B = 8 under the serving pool's
split plan, sweep_cases), bert (a full-width BertEncoder, 24 x 1024,
16 heads, FFN 4096, built on the card from --seed: layer -3 of one zh
sentence against the same weights' f32 CPU run, relative L2 < 1e-3; the
forward's device ms at 32 and 128 tokens), path (v2ProPlus with that BERT
and the port's tokenizer over a 21128-entry vocabulary: set_ref_audio +
several English `run` requests with random full-width weights made from
--seed; launch counts read from the CUDA code: one whole-step launch an S1
step), teacher (a greedy S1 trajectory through the kernel vs the plain
twin), path_zh (set_ref_audio with a zh transcript; a zh request with
numbers, a date and sandhi words, a zh-English one in "zh" mode and an
auto one with ja, ko and yue sentences; every g2p call's BERT rows
non-zero exactly on its zh phones, each of them seen by S1's bert_proj;
one K1 launch an S1 step; then g2pW on a synthetic bundle, its graph on
the card's ONNX executor, whose reading of 长 the request takes),
stream_v2 (one
run_streaming request: a fragment per segment, each of its tokens' length
plus the silence, and the time to the first), serve_v2 (the continuous
service on that pipeline: an 8-slot pool read mid-decode, every row's mask
and K/V where the layout puts them, the pool's own 8-row step held
against the twin, and that step profiled; then
12 requests from threads in three waves of 4 with mixed sampling: audio
lengths, one K1 launch a pool step, more than one live row, greedy
agreement >= 0.9 with `generate` and with a B=1 K1 decode by the pool's
rule, a seeded request's tokens alone as among co-tenants), http (the
api_v2 server over the service: 4 concurrent POST /tts, a streamed GET, a zh
and an auto POST answering 200, a made-up language 400); then for v4: kernels (K2, K3,
K5 at dim 1024, 16 x 64 heads, ff 2048, T=1024 with 1000 real frames, B in
{1, 4}, on inputs where a mask or rotary fault shows; K3 also with a q scale
and at T = 1000, K5 at T = 1000 and 2048; device time split into the GEMM or
flash_attn body and the row_quant / v_quant helper), path_v4 (set_ref_audio
with a transcript + two `run` requests through S1, the int8 DiT CFM and the
48 kHz vocoder, one of them a multi-chunk CFM batch; launch counts from the
CUDA code equal the per-call counts times the CFM calls, and one K1 launch
an S1 step), cfm_teacher (one full-width CFM chunk through the kernels and
through the twins, and its profile), http_v4 (one POST /tts through the v4
pipeline's batch branch); then for v3: v3_kernels (K6 at
BigVGAN's six stage shapes of a 2224-frame mel in bf16 and f32, timed, and
at rows off a 16-byte boundary and T = 1, 3, 7, 13, held only, on x of
amplitude 5-20 with per-channel alpha and beta, edges held on their own; K4
at (B, 16, 2560, 64) for B in {1, 4}, heads of different scales, 50x pad
rows under the mask), path_v3 (set_ref_audio with a transcript, then a
batched request at 24 kHz, a serial one with AP-BWE at 48 kHz and a streamed
one, through S1, the int8 DiT CFM, BigVGAN and AP-BWE; launch counts from
the CUDA code: 109 snake_aa a vocoder call, the v4 counts a CFM call, one K1
launch an S1 step), v3_profile (one BigVGAN and one AP-BWE call under the
profiler), snake_in_call (K6's 109 launches inside one BigVGAN call under
the profiler, and the device time its twins take in their place), cfm_long
(one CFM call at T=2560 through K3 -> SDPA -> K4 -> K2 and through the
twins); gemm_tiles (the s8 GEMM alone at each tile width, K2/K4's and K3's,
beside gemm_plan's choice); with --parent, compare_trees (K2, K4, K5, K3,
K1's step and K6 for one BigVGAN call timed on the earlier tree's kernels
and on this tree's, in turns);
then the `kernels` summary line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Bounds use the H100 SXM's
published peaks (3.35 TB/s; 989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s
f32), with the card's power limit printed beside them.
"""

from __future__ import annotations

import argparse
import json
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import torch

# the port first: without it (the script alone) nothing is printed
from gpt_sovits_tpu_torch import resolve_device
from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline, v3_chunk_plan
from gpt_sovits_tpu_torch.models.eres2net import ERes2NetV2
from gpt_sovits_tpu_torch.models.hubert import HubertEncoder
from gpt_sovits_tpu_torch.models.t2s import (
    EOS_MASK_WARMUP_STEPS, T2SDecoder, build_prefix_attn_bias, filter_logits, generate,
)
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


def device_events(fn, iters: int, attempts: int = 3, complete=None):
    """The device kernels of `iters` calls of fn(i) under torch.profiler
    (CUPTI), as key_averages() sums them by name. Now and then the profiler
    returns a window without any device event, or drops a few of them; a
    window that is empty, or that `complete(evs)` finds short, is run again,
    up to `attempts` times in all. None if no window came back whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        if evs and (complete is None or complete(evs)):
            return evs
    return None


def queued_ms(fn, iters: int) -> float:
    """Mean device time of fn(i) between two CUDA events, each call queued
    behind a spin kernel long enough for the host to enqueue the events and
    the call before the device reaches them, so that no launch gap falls
    between the events. For one kernel launch, its device time plus an
    event's few microseconds; read apart from the profiler."""
    fn(0)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for i in range(iters):
        torch.cuda._sleep(4_000_000)  # ~2 ms of clocks
        a.record()
        fn(i)
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


HELPERS = ("row_quant", "v_quant")  # kernel names of the int8 kernels' helper launches (row_quant_heads too)


def device_ms(fn, iters: int) -> tuple[float, str, dict]:
    """Mean device time of fn(i): the kernels' own busy time, without the
    launch gaps between them, and "profiler"; and that time split by kernel
    name into body_ms (the GEMM or flash_attn) and helper_ms (row_quant,
    row_quant_heads or v_quant). Where the profiler saw no device time, the
    CUDA-event time of the same calls, "events", and no split."""
    fn(0)
    torch.cuda.synchronize()
    evs = device_events(fn, iters)
    if evs is None:
        return cuda_ms(fn, iters), "events", {"body_ms": None, "helper_ms": None}
    total = sum(ev.self_device_time_total for ev in evs) / 1e3 / iters
    helper = sum(ev.self_device_time_total for ev in evs if any(h in ev.key for h in HELPERS)) / 1e3 / iters
    return total, "profiler", {"body_ms": total - helper, "helper_ms": helper}


def timings(prefix: str, fn, iters: int, split: bool = False) -> dict:
    """{prefix}ms (device), {prefix}timer, {prefix}wall_ms; with split, also
    body_ms and helper_ms from the same profiler window."""
    ms, timer, parts = device_ms(fn, iters)
    return {f"{prefix}ms": ms, f"{prefix}timer": timer, f"{prefix}wall_ms": cuda_ms(fn, iters),
            **(parts if split else {})}


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().mean() / (b.float().abs().mean() + 1e-12))


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------


def step_cache(b: int, g: torch.Generator, live: int = LIVE, t_pad: int = T_PAD):
    """A float (L, b, t_pad, 2D) K||V cache, a mask with a live prefix of
    `live` slots and a left-padding hole in row 0, and a hidden state x (B, D)."""
    dev = torch.device("cuda")
    kv_f = torch.randn((L, b, t_pad, 2 * D), generator=g, device=dev) * 0.5
    mask = torch.zeros((b, t_pad), device=dev)
    mask[:, :live] = 1.0
    mask[0, 5:37] = 0.0
    return kv_f, mask, torch.randn((b, D), generator=g, device=dev)


def _step_kv(kv_f: torch.Tensor, quant: str):
    return ds.quantize_kv_cache(kv_f) if quant == "int8" else (kv_f.to(torch.bfloat16), None)


def step_inputs(quant: str, b: int, g: torch.Generator, live: int = LIVE, t_pad: int = T_PAD):
    """step_cache's inputs with the cache in the given mode: kv, kv_s, mask, x."""
    kv_f, mask, x = step_cache(b, g, live, t_pad)
    return (*_step_kv(kv_f, quant), mask, x)


def peaked_step_inputs(w, quant: str, b: int, g: torch.Generator, live: int = LIVE, t_pad: int = T_PAD):
    """step_inputs with layer 0's attention peaked on the fresh token. For
    each (row, head), with q the scaled query that layer 0 makes of x (the
    twin's projection), the live keys score -30 and the keys of a hole
    masked in every row (slots 5..36) score +30 and carry V = 5. So the fresh
    K/V takes nearly all of layer 0's attention: a step that ignores the mask
    takes V = 5 from the hole instead, and one that drops the fresh K/V takes
    the mean of the live prefix's V."""
    kv_f, mask, x = step_cache(b, g, live, t_pad)
    w0 = ds.from_fragment_order(w["wqkv"][:1])[0].t()
    q = ds.proj_plain(x, w0, w["bqkv"][0], w["wqkv_s"][0] if quant == "int8" else None)[:, :D]
    q = (q * (1.0 / np.sqrt(D // H))).reshape(b, 1, H, D // H)
    u = (q / (q * q).sum(-1, keepdim=True)).reshape(b, 1, D)  # q . (c u) = c, head by head
    kv_f[0, :, :live, :D] = -30.0 * u
    kv_f[0, :, 5:37, :D] = 30.0 * u
    kv_f[0, :, 5:37, D:] = 5.0
    mask[:, 5:37] = 0.0
    return (*_step_kv(kv_f, quant), mask, x)


def hold_step(w, quant: str, kv, kv_s, mask, x, slots, plan_sweep=None) -> tuple[float, float]:
    """One step through the kernel and through the twin on the card, each
    on its own copy of the cache, writing at `slots`: an int, every row's
    slot, or one slot a row, passed as given (a (B,) tensor on the card, or
    a host list, as the serving pool passes it); the kernel's split plan
    chosen for `plan_sweep` (ds.step_plan; the twin has no splits). The
    hidden state and each row's new K/V at its slot within the JAX tests'
    bars (bf16: 2e-2 abs; int8: rel 0.02, the probability scale being per
    split); every other slot of the kernel's cache (and of its scales) as
    it was. Returns the hidden state's (max abs, mean rel) error."""
    b, t = mask.shape
    per_row = [slots] * b if isinstance(slots, int) else [int(v) for v in slots]
    rows = torch.arange(b, device=x.device)
    at = torch.tensor(per_row, device=x.device)

    def step(fn, **kw):
        return fn(x, w, kv.clone(), mask, slots, kv_s.clone() if kv_s is not None else None, num_heads=H, **kw)

    def new_kv(out):  # (L, B, 2D): row i's new K/V at its slot
        kv_new = out[1][:, rows, at].float()
        if quant == "int8":  # dequantize each side with its own per-token scales
            s_new = out[2][:, rows, :, at].transpose(0, 1)  # (L, B, 2)
            kv_new = torch.cat([kv_new[..., :D] * s_new[..., :1], kv_new[..., D:] * s_new[..., 1:]], -1)
        return kv_new

    got, ref = step(ds.fused_decode_step, plan_sweep=plan_sweep), step(ds.fused_decode_step_plain)
    e_abs, e_rel = float((got[0] - ref[0]).abs().max()), rel_err(got[0], ref[0])
    assert (e_rel < 0.02) if quant == "int8" else (e_abs < 2e-2), f"step B={b}: abs {e_abs} rel {e_rel}"
    kv_abs, kv_rel = float((new_kv(got) - new_kv(ref)).abs().max()), rel_err(new_kv(got), new_kv(ref))
    assert (kv_rel < 0.02) if quant == "int8" else (kv_abs < 2e-2), f"new K/V B={b}: abs {kv_abs} rel {kv_rel}"
    kept = torch.ones((b, t), dtype=torch.bool, device=x.device)
    kept[rows, at] = False
    assert torch.equal(got[1][:, kept], kv[:, kept]), f"step B={b} wrote outside its slots {per_row}"
    if quant == "int8":
        assert torch.equal(got[2].transpose(2, 3)[:, kept], kv_s.transpose(2, 3)[:, kept]), "scales outside the slots"
    return e_abs, e_rel


def step_cases(w, quant: str, b: int, g: torch.Generator, live: int = LIVE, t_pad: int = T_PAD) -> dict:
    """The whole step held against its twin (hold_step) on random inputs and
    on peaked_step_inputs, at a live prefix of `live` slots of t_pad; on the
    twin, what ignoring the mask would cost in the peaked case (a relative
    and an absolute shift above 0.2, ten times the bars)."""
    out = {}
    for case in ("random", "peaked"):
        kv, kv_s, mask, x = (step_inputs(quant, b, g, live, t_pad) if case == "random"
                             else peaked_step_inputs(w, quant, b, g, live, t_pad))
        e_abs, e_rel = hold_step(w, quant, kv, kv_s, mask, x, live)
        out[case] = {"max_abs_err": e_abs, "rel_err": e_rel}
    open_mask = mask.clone()
    open_mask[:, :live] = 1.0
    ref, nomask = (ds.fused_decode_step_plain(x, w, kv.clone(), m, live, kv_s.clone() if kv_s is not None else None,
                                              num_heads=H)[0] for m in (mask, open_mask))
    out["mask_shift"] = {"max_abs": float((nomask - ref).abs().max()), "rel": rel_err(nomask, ref)}
    assert out["mask_shift"]["rel"] > 0.2 and out["mask_shift"]["max_abs"] > 0.2, out
    return out


ROW_SLOTS = (LIVE, 201, LIVE - 1, 38)  # rows at different steps: row i writes at ROW_SLOTS[i]
# eight rows at different steps, all below 256 slots, stepped with the serving
# pool's split plan (its sweep, POOL's scratch + max_new = 1324): there K1's
# slot_r (4 int8, 2 bf16) is larger than step_splits would take for these
# slots (1), so the splits are fewer and longer than on any other path
SWEEP_SLOTS, PLAN_SWEEP = (200, 37, 255, 1, 128, 64, 90, 161), 1324


def rowwise_cases(w, quant: str, b: int, g: torch.Generator, row_slots=ROW_SLOTS, plan_sweep=None) -> dict:
    """The step with one write slot a row (a (B,) write_idx tensor, or with
    a plan sweep the host list the serving pool passes; rows at different
    steps, as continuous batching runs them), held as hold_step holds it:
    row i live over [0, row_slots[i]) under its mask, on random inputs and
    on peaked_step_inputs (every row's layer-0 attention peaked on its fresh
    token); each row's new K/V at its own slot, every other slot and scale
    unchanged."""
    slots = list(row_slots[:b])
    out = {"slots": slots, "plan": ds.step_plan(max(slots), quant == "int8", plan_sweep)}
    for case in ("random", "peaked"):
        kv, kv_s, mask, x = (step_inputs(quant, b, g) if case == "random" else peaked_step_inputs(w, quant, b, g))
        mask *= (torch.arange(T_PAD, device=mask.device)[None] < torch.tensor(slots, device=mask.device)[:, None])
        widx = slots if plan_sweep is not None else torch.tensor(slots, device=x.device)
        e_abs, e_rel = hold_step(w, quant, kv, kv_s, mask, x, widx, plan_sweep)
        out[case] = {"max_abs_err": e_abs, "rel_err": e_rel}
    return out


def sweep_cases(w, quant: str, g: torch.Generator) -> dict:
    """rowwise_cases at B=8 on SWEEP_SLOTS under the serving pool's plan
    sweep, where the plan's slot_r exceeds step_splits' for the step."""
    kv8 = quant == "int8"
    assert ds.step_splits(PLAN_SWEEP, kv8)[0] > ds.step_splits(max(SWEEP_SLOTS), kv8)[0]
    return rowwise_cases(w, quant, 8, g, SWEEP_SLOTS, PLAN_SWEEP)


def _s1_weights(quant: str) -> dict:
    """The stacked S1Config() weights made from seed 0, on the card."""
    torch.manual_seed(0)
    state = T2SDecoder(S1Config()).state_dict()
    return {k: v.to("cuda") for k, v in ds.stack_weights_from_params(state, L, quant=quant).items()}


def k1_case(quant: str, b: int, g: torch.Generator) -> dict:
    """step_cases at full width on S1Config() weights made from seed 0."""
    return step_cases(_s1_weights(quant), quant, b, g)


def k1_rows_case(quant: str, b: int, g: torch.Generator) -> dict:
    """rowwise_cases at full width on S1Config() weights made from seed 0."""
    return rowwise_cases(_s1_weights(quant), quant, b, g)


def k1_sweep_case(quant: str, g: torch.Generator) -> dict:
    """sweep_cases at full width on S1Config() weights made from seed 0."""
    return sweep_cases(_s1_weights(quant), quant, g)


def kernel_phase(s1_state: dict, quant: str, b: int, seed: int) -> dict:
    """K1's whole step at main-path shapes, held against its twin
    (step_cases) and timed, per 24-layer step."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    w = ds.stack_weights_from_params(s1_state, L, quant=quant)
    w = {k: v.to(dev) for k, v in w.items()}
    kv, kv_s, mask, x = step_inputs(quant, b, g)
    kind = "int8" if quant == "int8" else "bf16"
    # the whole step -----------------------------------------------------------
    held = step_cases(w, quant, b, g)
    kv_t, s_t = kv.clone(), (kv_s.clone() if kv_s is not None else None)

    def run_step(fn):
        return lambda i: fn(x, w, kv_t, mask, LIVE, s_t, num_heads=H)

    ops = 2 * b * sum(w[k].numel() for k in ("wqkv", "wo", "fc1", "fc2")) + L * 4 * b * H * LIVE * (D // H)
    # the step's ms: queued CUDA events, since late in this long process the
    # profiler now and then reads the step short (profiler_ms kept beside it)
    prof = timings("profiler_", run_step(ds.fused_decode_step), 10)
    step = dict(
        max_abs_err=max(held[c]["max_abs_err"] for c in ("random", "peaked")),
        rel_err=max(held[c]["rel_err"] for c in ("random", "peaked")), held=held,
        ms=queued_ms(run_step(ds.fused_decode_step), 20), timer="queued_events", wall_ms=prof["profiler_wall_ms"],
        profiler_ms=prof["profiler_ms"], profiler_timer=prof["profiler_timer"],
        **timings("plain_", run_step(ds.fused_decode_step_plain), 3), library_ms=None,
    )
    step["bound_ms"], step["bound_by"] = bound_ms(ds.step_bytes(w, kv, LIVE), ops, kind)
    assert step["ms"] >= step["bound_ms"], f"the step timed below its bound: {step}"
    if b == 1:
        emit({"phase": "profile", "mode": f"{quant}/{quant}", "B": b, **profile_steps(run_step(ds.fused_decode_step))})
    return step


def width_phase(s1_state: dict, seed: int) -> dict:
    """The whole step at every other batch width the path may run (segment
    batches of 2..7 rows), held against the twin on random and peaked
    inputs (step_cases), in both modes; at B = 2 on the longest live
    prefix the kernel takes (all STEP_MAX_SPLITS attention splits of a
    (row, head): 8192 slots with bf16 KV, 16384 with int8); at B = 2
    and 4 with one write slot a row (rowwise_cases); and at B = 8 with one
    write slot a row under the serving pool's split plan (sweep_cases)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}
    for quant in ("bf16", "int8"):
        w = {k: v.to(dev) for k, v in ds.stack_weights_from_params(s1_state, L, quant=quant).items()}
        cases = [step_cases(w, quant, b, g) for b in range(2, ds.MAX_ROWS)]
        errs = [c[case] for c in cases for case in ("random", "peaked")]
        out[f"{quant}/{quant}"] = {"max_abs_err": max(e["max_abs_err"] for e in errs),
                                   "max_rel_err": max(e["rel_err"] for e in errs)}
        reach = ds.STEP_MAX_SPLITS * 32 * (4 if quant == "int8" else 2)
        assert ds.step_splits(reach, quant == "int8")[1] == ds.STEP_MAX_SPLITS
        out[f"{quant}/{quant} live {reach}"] = step_cases(w, quant, 2, g, live=reach, t_pad=reach + 64)
        for b in (2, 4):
            out[f"{quant}/{quant} rows B={b}"] = rowwise_cases(w, quant, b, g)
        out[f"{quant}/{quant} rows B=8 sweep {PLAN_SWEEP}"] = sweep_cases(w, quant, g)
        torch.cuda.empty_cache()
    return out


def profile_steps(fn, steps: int = 5) -> dict:
    """Decode steps under torch.profiler: device time per step by kernel
    name, and the share of the (unprofiled) wall time the device sat idle
    (not measured where the profiler saw no device time)."""
    wall = cuda_ms(fn, steps)
    evs = device_events(fn, steps)
    if evs is None:
        return {"wall_ms_per_step": wall, "device_ms_per_step": None, "device_idle_share": None}
    by_name = {}  # kernels whose names share their first 60 characters are added up
    for ev in evs:
        row = by_name.setdefault(ev.key[:60], {"device_ms_per_step": 0.0, "calls_per_step": 0.0})
        row["device_ms_per_step"] += ev.self_device_time_total / 1e3 / steps
        row["calls_per_step"] += ev.count / steps
    busy = sum(ev.self_device_time_total for ev in evs) / 1e3 / steps
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms_per_step"])[:8])
    return {"wall_ms_per_step": wall, "device_ms_per_step": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall), "top_kernels": top}


# ---------------------------------------------------------------------------
# phase: path
# ---------------------------------------------------------------------------


def build_pipeline(seed: int, bert=None, tokenizer=None):
    torch.manual_seed(seed)  # random full-width weights, from the seed
    s1 = T2SDecoder(S1Config())
    s2 = SynthesizerTrn(s2_config_for_version("v2ProPlus"))
    hub = HubertEncoder()
    sv = ERes2NetV2()
    return TTSPipeline(s1_model=s1, s2_model=s2, hubert_model=hub, sv_model=sv, bert_model=bert,
                       bert_tokenizer=tokenizer)


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


class counted_steps:
    """Within the block, calls of ds.fused_decode_step (models/t2s.py
    generate makes one a decode step) are counted in `n`."""

    def __enter__(self):
        self.n, self.saved = 0, ds.fused_decode_step

        def step(*args, **kw):
            self.n += 1
            return self.saved(*args, **kw)

        ds.fused_decode_step = step
        return self

    def __exit__(self, *exc):
        ds.fused_decode_step = self.saved


def check_s1_launches(launches: dict, steps: int) -> dict:
    """One whole-step launch for every S1 step of a path."""
    assert steps > 0 and launches["fused_decode_step"] == steps, (launches, steps)
    return {"s1_steps": steps}


def path_phase(pipe, seed: int) -> dict:
    """The v2ProPlus requests; returns K1's launch counts over them, and the
    S1 steps they made."""
    t0 = time.perf_counter()
    pipe.set_ref_audio(reference_wav(seed), sr=32000)
    torch.cuda.synchronize()
    emit({"phase": "path", "event": "set_ref_audio", "s": time.perf_counter() - t0,
          "prompt_tokens": int(len(pipe.ref.prompt_semantic))})
    hop_up = int(np.prod(pipe.s2.cfg.upsample_rates))
    sr = pipe.mel_cfg.sampling_rate
    out = []
    n_steps = 0
    reset_all_launch_counts()
    for i, text in enumerate(REQUESTS):
        t0 = time.perf_counter()
        with counted_steps() as steps:
            sr_out, audio = pipe.run(text, "en", seed=seed + i, max_sec=MAX_SEC)
        n_steps += steps.n
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
    return {**ds.launch_counts(), "s1_steps": n_steps}


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


# ---------------------------------------------------------------------------
# BERT (chinese-roberta's shape, f32) and the zh path: phases bert, path_zh
# ---------------------------------------------------------------------------

BERT_VOCAB = 21128
BERT_BAR = 1e-3  # relative L2 of layer -3, card vs CPU, both f32 (TF32 off)
BERT_SENTENCE = "今天是二零二四年三月五日，银行行长说你好好想想。"
ZH_REQUESTS = [
    ("今天是2024年3月5日，气温25度。银行行长说：你好好想想，不要不要！我们一起去看看展览馆吧。一个一个来，第1名得了98.5分。",
     "zh"),
    ("我在用iPhone工作，这个App很好用。Let's go to the park, 好不好？", "zh"),
    ("こんにちは、元気ですか。안녕하세요, 반갑습니다. 佢哋今日去咗飲茶。", "auto"),
]
ZH_REF_TEXT = "这是参考音频的文本，说得很清楚。"
G2PW_SENTENCE = "他长得很高，长江很长。"  # 长: chang2 in the lexicon, zhang3 from the synthetic bundle


def bert_vocab() -> list[str]:
    """21128 entries laid out as chinese-roberta's vocab.txt: [PAD] 0,
    [unused1-99], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103; then ASCII and
    CJK punctuation, the hanzi of the port's zh_pinyin table and their "##"
    continuations, then the other CJK ideographs up to the size."""
    from gpt_sovits_tpu_torch.text.chinese import _lexicon

    words, chars = _lexicon()
    han_set = set(chars) | {c for w in words for c in w}
    han = sorted(han_set)
    rest = [chr(cp) for cp in range(0x4E00, 0xA000) if chr(cp) not in han_set]
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~…，。！？、：；") + han + ["##" + c for c in han] + rest)
    vocab = vocab[:BERT_VOCAB]
    assert len(vocab) == BERT_VOCAB and len(set(vocab)) == BERT_VOCAB, len(vocab)
    return vocab


def build_bert(seed: int):
    """Full-width BertEncoder(BertConfig()) (24 x 1024, 16 heads, FFN 4096)
    built on the card with weights from the seed, and the port's tokenizer
    over bert_vocab()."""
    from gpt_sovits_tpu_torch.models.bert import BertConfig, BertEncoder
    from gpt_sovits_tpu_torch.text.bert_tokenizer import BertTokenizer

    torch.manual_seed(seed)
    with torch.device("cuda"):
        bert = BertEncoder(BertConfig()).eval()
    return bert, BertTokenizer(bert_vocab())


def bert_bound_ms(cfg, t: int) -> tuple[float, str]:
    """The least time of a forward at t tokens: its weights and activations
    read once and the hidden states written once, or its f32 operations."""
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    weights = n * (4 * d * d + 2 * d * f) + (t + 2) * d  # the embedding rows it reads
    ops = n * (2 * t * (4 * d * d + 2 * d * f) + 4 * t * t * d)
    return bound_ms(4 * (weights + (n + 1) * t * d), ops, "f32")


def bert_phase(bert, tok, seed: int) -> dict:
    """Layer -3 of one zh sentence on the card against the same weights'
    f32 CPU run; the forward's device and wall ms at 32 and 128 tokens."""
    from gpt_sovits_tpu_torch.models.bert import BertEncoder
    from gpt_sovits_tpu_torch.text.chinese import normalize

    ids = torch.from_numpy(tok(normalize(BERT_SENTENCE))["input_ids"])
    assert ids.shape[1] > 10 and (ids[0, 1:-1] != 100).all(), ids  # no [UNK]: the vocabulary covers the sentence
    cpu = BertEncoder(bert.cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in bert.state_dict().items()})
    with torch.no_grad():
        got = bert(ids.cuda())[-3].cpu()
        want = cpu(ids)[-3]
    rel = float((got - want).norm() / want.norm())
    assert got.shape == (1, ids.shape[1], 1024) and torch.isfinite(got).all() and rel < BERT_BAR, rel
    del cpu
    g = torch.Generator().manual_seed(seed)
    times = {}
    for t in (32, 128):
        x = torch.randint(1000, BERT_VOCAB, (1, t), generator=g).cuda()
        with torch.no_grad():
            ms, timer, _ = device_ms(lambda i: bert(x), 10)
            wall = cuda_ms(lambda i: bert(x), 10)
            evs = device_events(lambda i: bert(x), 5) or []
        b, by = bert_bound_ms(bert.cfg, t)
        top = sorted(evs, key=lambda ev: -ev.self_device_time_total)[:6]
        times[t] = {"device_ms": ms, "timer": timer, "wall_ms": wall, "bound_ms": b, "bound_by": by,
                    "launches": sum(ev.count for ev in evs) / 5,
                    "top_kernels": {ev.key[:80]: {"ms": ev.self_device_time_total / 1e3 / 5, "launches": ev.count / 5}
                                    for ev in top}}
    return {"tokens": int(ids.shape[1]), "layer_m3_rel_l2": rel, "bar": BERT_BAR, "ms": times,
            "tf32": torch.backends.cuda.matmul.allow_tf32, "nvidia_smi": card_line()}


def write_g2pw_bundle(d: Path) -> None:
    """The synthetic G2PWModel bundle of tests/test_g2pw.py: polyphones 长
    (CH2, ZH3) and 行 (X2, H2), a classifier graph that picks ZH3 for 长 and
    X2 for 行, written with the port's encode_model."""
    from gpt_sovits_tpu_torch.utils.onnx_lite import Graph, Node, encode_model

    d.mkdir(parents=True)
    (d / "POLYPHONIC_CHARS.txt").write_text("长\tCH2\n长\tZH3\n行\tX2\n行\tH2", encoding="utf-8")
    (d / "MONOPHONIC_CHARS.txt").write_text("好\tHAO3", encoding="utf-8")
    (d / "bopomofo_to_pinyin_wo_tune_dict.json").write_text(
        json.dumps({"CH": "chang", "ZH": "zhang", "X": "xing", "H": "hang", "HAO": "hao"}), encoding="utf-8")
    (d / "char_bopomofo_dict.json").write_text("{}", encoding="utf-8")
    (d / "config.py").write_text("use_mask = True\nuse_char_phoneme = False\n", encoding="utf-8")
    table = np.array([[0.0, 0.0, 5.0, 0.0], [0.0, 0.0, 0.0, 5.0]], np.float32)  # 行 -> X2, 长 -> ZH3
    g = Graph(
        nodes=[Node("Gather", ["table", "char_ids"], ["logits"], {"axis": 0}),
               Node("Mul", ["logits", "phoneme_mask"], ["masked"], {}),
               Node("Softmax", ["masked"], ["probs"], {"axis": -1})],
        initializers={"table": table},
        inputs=["input_ids", "token_type_ids", "attention_mask", "phoneme_mask", "char_ids", "position_ids"],
        outputs=["probs"],
    )
    (d / "g2pW.onnx").write_bytes(encode_model(g))


def zh_rows(text: str, language: str, version: str) -> np.ndarray:
    """For each phone of `_g2p_segment(text, language)`, whether it comes
    from a zh run."""
    import re

    from gpt_sovits_tpu_torch.text.cleaner import clean_text
    from gpt_sovits_tpu_torch.text.lang_segmenter import runs_for_language

    runs = runs_for_language(re.sub(r" {2,}", " ", text), language)
    return np.concatenate([np.full(len(clean_text(r["text"], r["lang"], version)[0]), r["lang"] == "zh")
                           for r in runs] or [np.zeros(0, bool)])


class recorded_g2p:
    """Within the block, every `_g2p_segment` call of the pipeline and the
    rows that S1's bert_proj sees (a forward hook) are recorded."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __enter__(self):
        self.calls, self.proj_rows = [], []
        inner = self.pipe._g2p_segment

        def g2p(text, language):
            out = inner(text, language)
            self.calls.append((text, language, out))
            return out

        self.pipe._g2p_segment = g2p
        self.hook = self.pipe.s1.bert_proj.register_forward_hook(
            lambda mod, args, out: self.proj_rows.append(args[0].detach().float().cpu().reshape(-1, args[0].shape[-1])))
        return self

    def __exit__(self, *exc):
        del self.pipe._g2p_segment
        self.hook.remove()

    def check(self) -> dict:
        """Each call's BERT rows are non-zero exactly on its zh phones, and
        S1's bert_proj saw each of those rows."""
        zh_total = 0
        for text, language, (ids, bert, _) in self.calls:
            want = zh_rows(text, language, self.pipe.version)
            got = np.abs(bert).sum(-1) > 0
            assert got.shape == want.shape == (len(ids),) and (got == want).all(), (text, language, got, want)
            zh_total += int(want.sum())
        seen = torch.cat(self.proj_rows)
        seen = seen[seen.abs().sum(-1) > 0]
        assert zh_total > 0 and len(seen) >= zh_total, (zh_total, len(seen))
        for _, _, (_, bert, _) in self.calls:
            for row in torch.from_numpy(bert[np.abs(bert).sum(-1) > 0]):
                assert (seen == row).all(-1).any(), "a zh row of BERT features never reached bert_proj"
        return {"g2p_calls": len(self.calls), "zh_phones": zh_total, "bert_proj_nonzero_rows": int(len(seen))}


def zh_request(pipe, i: int, text: str, lang: str, seed: int) -> dict:
    """One `run` request of path_zh: its int16 audio of the length its S1
    tokens give (as `path` checks it), its RTF and phases."""
    hop_up = int(np.prod(pipe.s2.cfg.upsample_rates))
    sr = pipe.mel_cfg.sampling_rate
    t0 = time.perf_counter()
    sr_out, audio = pipe.run(text, lang, seed=seed + i, max_sec=MAX_SEC)
    wall = time.perf_counter() - t0
    assert sr_out == sr and audio.dtype == np.int16, (sr_out, audio.dtype)
    n_seg = len(pipe.last_tokens)
    expect = sum(n * 2 * hop_up for n in pipe.last_tokens.values()) + (n_seg - 1) * int(sr * pipe.cfg.fragment_interval)
    assert audio.shape == (expect,) and np.isfinite(audio.astype(np.float32)).all(), (audio.shape, expect)
    return {"phase": "path_zh", "request": i, "language": lang, "segments": n_seg,
            "tokens": list(pipe.last_tokens.values()), "audio_s": len(audio) / sr, "wall_s": wall,
            "rtf": wall / (len(audio) / sr), "phases_s": pipe.last_timing}


def g2pw_request(pipe, i: int, seed: int, tmp: str) -> dict:
    """G2PW_SENTENCE with the synthetic g2pW bundle enabled (its graph on
    the card's ONNX executor): every 长 takes the bundle's zhang3, so the
    phones differ from the lexicon's; the bundle is disabled afterwards."""
    from gpt_sovits_tpu_torch.text import g2pw
    from gpt_sovits_tpu_torch.text.chinese import _g2pw_segment
    from gpt_sovits_tpu_torch.text.cleaner import clean_text

    bundle = Path(tmp) / "G2PWModel"
    write_g2pw_bundle(bundle)
    plain = clean_text(G2PW_SENTENCE, "zh")[0]
    model = g2pw.enable(str(bundle), pipe.bert_tokenizer).model
    runs = []
    inner = model.run
    model.run = lambda feeds: runs.append(1) or inner(feeds)
    try:
        rec = zh_request(pipe, i, G2PW_SENTENCE, "zh", seed)
        hanzi = G2PW_SENTENCE.replace("，", "").replace("。", "")
        chang = [r for c, r in zip(hanzi, _g2pw_segment(hanzi)) if c == "长"]
        taken = clean_text(G2PW_SENTENCE, "zh")[0]
    finally:
        g2pw.disable()
    assert chang == ["zhang3"] * 3 and taken != plain and "ang3" in taken, (chang, taken, plain)
    assert model.device.type == "cuda" and runs, (model.device, runs)
    return {**rec, "g2pw_readings_chang": chang, "onnx_runs_on_card": len(runs)}


def path_zh_phase(pipe, seed: int, tmp: str) -> dict:
    """zh, zh-English ("zh" mode) and auto requests on the v2ProPlus pipeline
    with BERT, after set_ref_audio with a zh transcript; then one with g2pW's
    synthetic bundle on the card's ONNX executor. K1 launches are counted
    from 0 just before the requests and read just after."""
    t0 = time.perf_counter()
    pipe.set_ref_audio(reference_wav(seed), sr=32000, ref_text=ZH_REF_TEXT)
    torch.cuda.synchronize()
    assert pipe.ref.prompt_phones, pipe.ref
    emit({"phase": "path_zh", "event": "set_ref_audio", "s": time.perf_counter() - t0,
          "prompt_phones": len(pipe.ref.prompt_phones)})
    reset_all_launch_counts()
    with counted_steps() as steps, recorded_g2p(pipe) as rec:
        out = [zh_request(pipe, i, text, lang, seed) for i, (text, lang) in enumerate(ZH_REQUESTS)]
        out.append(g2pw_request(pipe, len(out), seed, tmp))
    launches = ds.launch_counts()
    for r in out:
        emit(r)
    assert any(r["segments"] > 1 for r in out), "no zh request ran a batch of several segments"
    return {**launches, "s1_steps": steps.n, **rec.check()}


def path_zh_case(g: torch.Generator) -> dict:
    """path_zh on its own (the broken copies' check): a full-width
    v2ProPlus pipeline with BERT from seed 0, then path_zh_phase."""
    bert, tok = build_bert(0)
    pipe = build_pipeline(0, bert, tok)
    with tempfile.TemporaryDirectory(prefix="gsv_smoke_") as tmp:
        rec = path_zh_phase(pipe, 0, tmp)
    check_s1_launches(rec, rec["s1_steps"])
    return rec


# ---------------------------------------------------------------------------
# v4: the int8 DiT kernels K2, K3, K5 (csrc/qmatmul.cu, csrc/qflash.cu)
# ---------------------------------------------------------------------------

V4_DIM, V4_HEADS, V4_DH, V4_FF = 1024, 16, 64, 2048
V4_T, V4_REAL = 1024, 1000  # one CFM chunk: T padded to 1024, 1000 real frames
V4_SRC = {"qdense_int8": "gpt_sovits_tpu_torch/csrc/qmatmul.cu", "qkv_rope_int8": "gpt_sovits_tpu_torch/csrc/qmatmul.cu",
          "flash_attn_int8": "gpt_sovits_tpu_torch/csrc/qflash.cu"}
V4_REPLACES = {"qdense_int8": "gpt_sovits_tpu/ops/pallas/qmatmul.py:86",
               "qkv_rope_int8": "gpt_sovits_tpu/ops/pallas/qmatmul.py:234",
               "flash_attn_int8": "gpt_sovits_tpu/ops/pallas/qflash.py:94"}
V4_BAR = 2e-2  # max abs error within 2% of the output's max (one int8 code or bf16 ulp moves an element far less)


def _qweight(n: int, k: int, g: torch.Generator):
    """Random (N, K) weights quantized per output channel, as
    quantize_dit_params does: int8 codes, f32 scales, f32 biases."""
    dev = torch.device("cuda")
    w = torch.randn((n, k), generator=g, device=dev) / np.sqrt(k)
    s = torch.clamp_min(w.abs().amax(1) / 127.0, 1e-12)
    return (torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8), s,
            (0.1 * torch.randn(n, generator=g, device=dev)).contiguous())


def _held(name: str, got, ref) -> dict:
    got, ref = got.float(), ref.float()
    e, top = float((got - ref).abs().max()), float(ref.abs().max())
    out = {"max_abs_err": e, "out_max": top, "rel_err": rel_err(got, ref)}
    assert e <= V4_BAR * top, f"{name} disagrees with its twin: {out}"
    return out


def _mm_bytes(m: int, k: int, n: int) -> int:
    """x (bf16) read, int8 W and its f32 scales and biases read, bf16 out written."""
    return m * k * 2 + n * k + n * 8 + m * n * 2


def k2_block(b: int, t: int, real: int, g: torch.Generator):
    """K2's three calls of one DiT block at v4 widths, B rows of T frames
    (`real` of them real): name -> (call(fn), (M, K, N), epilogue bytes),
    and res. to_out has the mask and the gated residual, and x's pad rows
    are 50x larger (a copy that drops the mask moves them far past the bar);
    ff1 the AdaLN prologue and gelu; ff2 the gated residual."""
    dev = torch.device("cuda")
    m, d, f = b * t, V4_DIM, V4_FF
    bf = torch.bfloat16
    mask = torch.zeros((b, t), device=dev)
    mask[:, :real] = 1.0
    x = torch.randn((b, t, d), generator=g, device=dev)
    x[:, real:] *= 50.0
    x = x.to(bf).contiguous()
    h1 = torch.randn((b, t, f), generator=g, device=dev).to(bf)
    res = torch.randn((b, t, d), generator=g, device=dev).to(bf)
    gate = (0.5 * torch.randn((b, d), generator=g, device=dev)).contiguous()
    sc, sh = ((0.3 * torch.randn((b, d), generator=g, device=dev)).contiguous() for _ in range(2))
    w_out, w_ff1, w_ff2 = _qweight(d, d, g), _qweight(f, d, g), _qweight(d, f, g)
    return {
        "to_out": (lambda fn: fn(x, *w_out, res_gate=(res, gate), mask=mask), (m, d, d), 2 * m * d),
        "ff1": (lambda fn: fn(x, *w_ff1, ln_mod=(sc, sh), act="gelu"), (m, d, f), 2 * b * d * 4),
        "ff2": (lambda fn: fn(h1, *w_ff2, res_gate=(res, gate)), (m, f, d), 2 * m * d + b * d * 4),
    }, res


def hold_k2(calls: dict, res, real: int) -> dict:
    """Each K2 call held against its twin; to_out's pad rows carry the
    residual alone."""
    from gpt_sovits_tpu_torch.ops import qmatmul as qm

    held = {}
    for name, (call, _, _) in calls.items():
        got, ref = call(qm.qdense_int8), call(qm.qdense_int8_plain)
        held[name] = _held(f"qdense_int8 {name}", got, ref)
        if name == "to_out":
            assert float((got[:, real:].float() - res[:, real:].float()).abs().max()) <= 1e-2, "mask ignored"
    return held


def gemm_case(b: int, t: int, g: torch.Generator) -> dict:
    """K2's block at B rows of T frames where B x T is no multiple of the
    GEMM's 128-row tiles (its last row block is ragged), the last 40 frames
    pads: held against the twins (a plan or kernel that drops the ragged
    block leaves those rows unwritten)."""
    calls, res = k2_block(b, t, t - 40, g)
    return hold_k2(calls, res, t - 40)


def k3_call(b: int, t: int, g: torch.Generator, q_scale: float = 1.0):
    """K3's inputs at v4 widths (dim 1024, 16 x 64 heads), B rows of T
    frames, with the AdaLN prologue: call(fn) -> (q, k, v), and the three
    (codes, scales, biases) weights."""
    dev = torch.device("cuda")
    d = V4_DIM
    x = torch.randn((b, t, d), generator=g, device=dev).to(torch.bfloat16)
    sc, sh = ((0.3 * torch.randn((b, d), generator=g, device=dev)).contiguous() for _ in range(2))
    wqkv = [_qweight(d, d, g) for _ in range(3)]

    def call(fn):
        return fn(x, *(w[0] for w in wqkv), *(w[1] for w in wqkv), *(w[2] for w in wqkv), ln_mod=(sc, sh),
                  dim_head=V4_DH, q_scale=q_scale)

    return call, wqkv


def k3_hold(call, t: int) -> dict:
    """K3 held against its twin, each output within 2% of its max; on the
    twin, what a rotation fault would cost at positions 0..T-1 (head 0 of q
    unrotated against rotated)."""
    from gpt_sovits_tpu_torch.ops import qmatmul as qm

    got, ref = call(qm.qkv_rope_int8), call(qm.qkv_rope_int8_plain)
    held = {nm: _held(f"qkv_rope_int8 {nm}", a, r) for nm, a, r in zip("qkv", got, ref)}
    cos, sin = qm.rope_table(t, V4_DH, ref[0].device)
    q0 = ref[0][:, 0].float()
    unrot = torch.stack([q0[..., 0::2] * cos + q0[..., 1::2] * sin, q0[..., 1::2] * cos - q0[..., 0::2] * sin], -1)
    held["rotation_shift"] = float((unrot.reshape(q0.shape) - q0).abs().max())
    assert held["rotation_shift"] > 10 * V4_BAR * held["q"]["out_max"], held
    return held


def k3_case(b: int, t: int, q_scale: float, g: torch.Generator) -> dict:
    """K3 at v4 widths, B rows of T frames (B x T need not be a multiple of
    the GEMM's 128-row tiles), with a static q scale: k3_hold. A copy that
    rotates no head or every head, reads the rotary table off by one
    position, drops q_scale (q_scale != 1) or writes v from k's weights
    fails it."""
    return k3_hold(k3_call(b, t, g, q_scale)[0], t)


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 0.0


def k5_inputs(b: int, t: int, real: int, g: torch.Generator):
    """K5's inputs at v4 widths (16 x 64 heads), B rows of T frames, `real`
    of them real: the mask and two cases of (q, k, v) bf16. random; peaked:
    every query of a head along one direction u, keys 12u with V = 6 planted
    in the pad region (ignoring the mask moves every row), and three live
    keys 10u (at 100, 400, 900, or spread over the real keys of a shorter
    T) that carry the rows' weight."""
    dev = torch.device("cuda")
    mask = torch.zeros((b, t), device=dev)
    mask[:, :real] = 1.0
    q, k, v = (torch.randn((b, V4_HEADS, t, V4_DH), generator=g, device=dev) for _ in range(3))
    qp = q.clone()
    u = q[:, :, :1] / q[:, :, :1].norm(dim=-1, keepdim=True)
    qp[:] = 6.0 * u
    kp, vp = k.clone(), v.clone()
    kp[:, :, real:] = 12.0 * u
    vp[:, :, real:] = 6.0
    for tt in (100, 400, 900) if real > 900 else (real // 10, real // 2, real - 20):
        kp[:, :, tt] = 10.0 * u[:, :, 0]
    bf = torch.bfloat16
    cases = {"random": (q, k, v), "peaked": (qp, kp, vp)}
    return mask, {c: tuple(z.to(bf).contiguous() for z in zs) for c, zs in cases.items()}


def k5_case(b: int, t: int, real: int, g: torch.Generator) -> dict:
    """K5 at (B, 16, T, 64), `real` real keys, on k5_inputs' random and
    peaked cases: within 2% of the output's max over the real rows, and the
    peaked case within one bf16 step of its max (its codes are the twin's
    but where f32 sums round apart). On the twin, what ignoring the mask
    would cost in the peaked case."""
    from gpt_sovits_tpu_torch.ops import qflash as qf

    sm = 1.0 / np.sqrt(V4_DH)
    mask, cases = k5_inputs(b, t, real, g)
    held = {}
    for case, (q, k, v) in cases.items():
        got = qf.flash_attn_int8(q, k, v, mask, sm_scale=sm)
        ref = qf.flash_attn_int8_plain(q, k, v, mask, sm_scale=sm)
        held[case] = _held(f"flash_attn_int8 {case} B={b} T={t}", got[:, :real], ref[:, :real])
        if case == "peaked":
            step = bf16_step(held[case]["out_max"])
            assert held[case]["max_abs_err"] <= step, f"flash_attn_int8 peaked B={b} T={t}: {held[case]}, step {step}"
            nomask = qf.flash_attn_int8_plain(q, k, v, None, sm_scale=sm)
            held["mask_shift"] = float((nomask[:, :real].float() - ref[:, :real].float()).abs().max())
            assert held["mask_shift"] > 10 * V4_BAR * held[case]["out_max"], held
    return held


def v4_kernel_phase(b: int, seed: int) -> dict:
    """K2 (three DiT variants), K3 and K5 at v4 shapes (dim 1024, 16 x 64
    heads, ff 2048, T 1024 with 1000 real frames), B rows; each held against
    its twin on the card, on inputs where a fault shows (k2_block,
    k5_inputs; K3 runs positions 0..1023, where rotating every head, or
    none, moves the output by about its size, and is also held with a q
    scale and at T = 1000, a ragged M). K5 is also held at T = 1000 (a
    partial last key tile) and T = 2048 (MAX_INT8_T)."""
    from gpt_sovits_tpu_torch.ops import qflash as qf
    from gpt_sovits_tpu_torch.ops import qmatmul as qm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    m, t, d = b * V4_T, V4_T, V4_DIM
    rows = {}

    # K2: the attention output (mask + gated residual), ff1 (AdaLN + gelu), ff2 (gated residual)
    variants, res = k2_block(b, t, V4_REAL, g)
    held = hold_k2(variants, res, V4_REAL)
    nbytes = sum(_mm_bytes(mm, kk, nn) + extra for _, (mm, kk, nn), extra in variants.values())
    ops = sum(2 * mm * kk * nn for _, (mm, kk, nn), _ in variants.values())
    lib_in = [(torch.randint(-127, 128, (mm, kk), generator=g, device=dev, dtype=torch.int8),
               torch.randint(-127, 128, (nn, kk), generator=g, device=dev, dtype=torch.int8))
              for _, (mm, kk, nn), _ in variants.values()]
    block = lambda fn: [c(fn) for c, _, _ in variants.values()]  # noqa: E731
    bound, by = bound_ms(nbytes, ops, "int8")
    rows["qdense_int8"] = dict(
        max_abs_err=max(h["max_abs_err"] for h in held.values()), held=held,
        **timings("", lambda i: block(qm.qdense_int8), 20, split=True),
        **timings("plain_", lambda i: block(qm.qdense_int8_plain), 3),
        **timings("library_", lambda i: [torch._int_mm(a, w.t()) for a, w in lib_in], 20),
        bound_ms=bound, bound_by=by, config=f"B={b}: to_out + ff1 + ff2 of one DiT block (3 launches)")

    # K3: q, k, v with the AdaLN prologue and rotary on head 0; the DiT's
    # call, then with a q scale, then at a ragged M (T = 1000)
    qkv, wqkv = k3_call(b, t, g)
    held = k3_hold(qkv, t)
    held["q_scale=0.125"] = k3_case(b, t, 0.125, g)
    held["T=1000"] = k3_case(b, 1000, 1.0, g)
    xq_lib = torch.randint(-127, 128, (m, d), generator=g, device=dev, dtype=torch.int8)
    bound, by = bound_ms(m * d * 2 + 3 * (d * d + 8 * d) + 3 * m * d * 2 + 2 * b * d * 4, 3 * 2 * m * d * d, "int8")
    rows["qkv_rope_int8"] = dict(
        max_abs_err=max(h["max_abs_err"] for hh in (held, held["q_scale=0.125"], held["T=1000"])
                        for h in hh.values() if isinstance(h, dict) and "max_abs_err" in h), held=held,
        **timings("", lambda i: qkv(qm.qkv_rope_int8), 20, split=True),
        **timings("plain_", lambda i: qkv(qm.qkv_rope_int8_plain), 3),
        **timings("library_", lambda i: [torch._int_mm(xq_lib, w[0].t()) for w in wqkv], 20),
        bound_ms=bound, bound_by=by, config=f"B={b}, T={t}")

    # K5: random and peaked at the chunk's T, then at T = 1000 and 2048
    held = k5_case(b, t, V4_REAL, g)
    held["T=1000"] = k5_case(b, 1000, 960, g)
    held["T=2048"] = k5_case(b, 2048, 2000, g)
    mask, cases = k5_inputs(b, t, V4_REAL, g)
    qb, kb, vb = cases["random"]
    sm = 1.0 / np.sqrt(V4_DH)
    attn_mask = (mask > 0)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qk_ops = 2 * b * V4_HEADS * t * t * V4_DH
    bound = max(qk_ops / PEAK_OPS["bf16"] * 1e3 + qk_ops / PEAK_OPS["int8"] * 1e3,
                (4 * b * V4_HEADS * t * V4_DH * 2 + b * t * 4) / HBM_BYTES_S * 1e3)
    errs = [h["max_abs_err"] for hh in (held, held["T=1000"], held["T=2048"]) for h in hh.values()
            if isinstance(h, dict) and "max_abs_err" in h]
    rows["flash_attn_int8"] = dict(
        max_abs_err=max(errs), held=held,
        **timings("", lambda i: qf.flash_attn_int8(qb, kb, vb, mask, sm_scale=sm), 20, split=True),
        **timings("plain_", lambda i: qf.flash_attn_int8_plain(qb, kb, vb, mask, sm_scale=sm), 3),
        **timings("library_", lambda i: sdpa(qb, kb, vb, attn_mask=attn_mask), 20),
        bound_ms=bound, bound_by="operations", config=f"B={b}, H=16, T={t}, {V4_REAL} real keys")
    return rows


def gemm_tile_phase(seed: int) -> dict:
    """The qdense GEMM alone (no row_quant, no epilogue inputs) at each tile
    width it is built for, on the main path's (M, K, N) at B = 1 and 4 and
    K4's: device ms by width (each timed twice, in turns) beside
    gemm_plan's choice, and the widths' outputs equal (s32 sums are
    exact, the epilogue is the same)."""
    from gpt_sovits_tpu_torch.ops import qmatmul as qm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 70)
    out = {}
    for b in (1, 4):
        shapes = {"to_out": (b * V4_T, V4_DIM, V4_DIM), "ff1": (b * V4_T, V4_DIM, V4_FF),
                  "ff2": (b * V4_T, V4_FF, V4_DIM), "k4": (b * K4_T, V4_DIM, V4_DIM)}
        for name, (m, k, n) in shapes.items():
            xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
            sx = torch.rand(m, generator=g, device=dev) + 0.5
            w, sw, bias = _qweight(n, k, g)
            row = {"M": m, "K": k, "N": n, "plan": qm.gemm_plan(m, n)[0]}
            ys = []
            for tn in (*qm.GEMM_TILES_N, *qm.GEMM_TILES_N):
                run = lambda i, tn=tn: qm._gemm(xq, sx, w, sw, bias, None, None, None, m, tile_n=tn)  # noqa: E731
                ys.append(run(0))
                row.setdefault(f"ms_{tn}", []).append(device_ms(run, 50)[0])
            assert all(torch.equal(ys[0], y) for y in ys), f"qdense tile widths disagree at {name} B={b}"
            out[f"{name} B={b}"] = row
        # K3's GEMM: three projections in one grid
        m, k, n = b * V4_T, V4_DIM, V4_DIM
        xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        sx = torch.rand(m, generator=g, device=dev) + 0.5
        ws = [_qweight(n, k, g) for _ in range(3)]
        row = {"M": m, "K": k, "N": n, "z": 3, "plan": qm.gemm_plan(m, n, 3)[0]}
        ys = []
        for tn in (*qm.GEMM_TILES_N, *qm.GEMM_TILES_N):
            run = lambda i, tn=tn: qm._qkv_gemm(xq, sx, *zip(*ws), b, V4_T, V4_DH, 1.0, tile_n=tn)  # noqa: E731
            ys.append(run(0))
            row.setdefault(f"ms_{tn}", []).append(device_ms(run, 50)[0])
        assert all(all(torch.equal(a, c) for a, c in zip(ys[0], y)) for y in ys), f"qkv_rope tile widths disagree B={b}"
        out[f"qkv_rope B={b}"] = row
    return out


V4_MAX_SEC = 8  # S1 cap per segment on the v4 path: 200 tokens, 800 mel frames; keeps the CFM bucket <= 6
V4_REQUESTS = [
    "Hello there, this is a short test of the flow matching path.",
    "The first sentence is short. The second one is a little longer than the first! "
    "And a third sentence closes the request.",
]
V4_PER_CFM_CALL = {"qkv_rope_int8": 22 * 32, "flash_attn_int8": 22 * 32, "qdense_int8": 3 * 22 * 32,
                   "row_quant": 4 * 22 * 32, "v_quant": 22 * 32}


def all_launch_counts() -> dict:
    from gpt_sovits_tpu_torch.ops import qflash as qf
    from gpt_sovits_tpu_torch.ops import qmatmul as qm
    from gpt_sovits_tpu_torch.ops import snake_aa as sa

    return {**ds.launch_counts(), **qm.launch_counts(), **qf.launch_counts(), **sa.launch_counts()}


def reset_all_launch_counts() -> None:
    from gpt_sovits_tpu_torch.ops import qflash as qf
    from gpt_sovits_tpu_torch.ops import qmatmul as qm
    from gpt_sovits_tpu_torch.ops import snake_aa as sa

    for mod in (ds, qm, qf, sa):
        mod.reset_launch_counts()


def build_v4_pipeline(seed: int):
    """v4 at full width, random weights from the seed: S1Config(), the v4
    SynthesizerTrnV3 (DiT 22 x 1024, 16 heads), the x480 vocoder, CNHuBERT."""
    from gpt_sovits_tpu_torch.infer.pipeline import V3Bundle, serving_t_chunk
    from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
    from gpt_sovits_tpu_torch.models.vits import Generator
    from gpt_sovits_tpu_torch.utils.config import MEL_V4, vocoder_v4_config

    torch.manual_seed(seed)
    cfg = s2_config_for_version("v4")
    bundle = V3Bundle(
        model=SynthesizerTrnV3(cfg),
        vocoder=Generator(vocoder_v4_config(), in_channels=cfg.cfm_mel_channels, use_post_bias=True, conditioned=False),
        mel_cfg=MEL_V4, t_ref=500, t_chunk=serving_t_chunk("v4", "cuda"), out_sr=48000, sample_steps=32,
    )
    return TTSPipeline(s1_model=T2SDecoder(S1Config()), s2_model=None, hubert_model=HubertEncoder(), v3_bundle=bundle)


def path_v4_phase(pipe, seed: int) -> list[dict]:
    t0 = time.perf_counter()
    pipe.set_ref_audio(reference_wav(seed), sr=32000, ref_text="This is the reference voice speaking clearly.")
    pipe._v3_ref_features()
    torch.cuda.synchronize()
    emit({"phase": "path_v4", "event": "set_ref_audio", "s": time.perf_counter() - t0,
          "prompt_tokens": int(len(pipe.ref.prompt_semantic)), "dit_quant": pipe.dit_quant, "t_chunk": pipe.v3.t_chunk})
    sr = pipe.v3.out_sr
    up = sr * pipe.v3.mel_cfg.hop_size // pipe.v3.mel_cfg.sampling_rate
    out = []
    for i, text in enumerate(V4_REQUESTS):
        t0 = time.perf_counter()
        sr_out, audio = pipe.run(text, "en", seed=seed + i, max_sec=V4_MAX_SEC)
        wall = time.perf_counter() - t0
        assert sr_out == 48000 and audio.dtype == np.int16, (sr_out, audio.dtype)
        n_seg = len(pipe.last_tokens)
        expect = sum(pipe._mel_len_for(n, 1.0) * up for n in pipe.last_tokens.values())
        expect += (n_seg - 1) * int(sr * pipe.cfg.fragment_interval)
        assert audio.shape == (expect,), (audio.shape, expect)
        assert np.isfinite(audio.astype(np.float32)).all()
        rec = {"phase": "path_v4", "request": i, "segments": n_seg, "tokens": list(pipe.last_tokens.values()),
               "cfm_batch": [list(b) for b in pipe.last_cfm_batch], "audio_s": len(audio) / sr, "wall_s": wall,
               "rtf": wall / (len(audio) / sr), "phases_s": pipe.last_timing}
        emit(rec)
        out.append(rec)
    assert any(b[0] > 1 for r in out for b in r["cfm_batch"]), "no request ran a CFM batch of several chunks"
    assert all(b[1] <= 6 for r in out for b in r["cfm_batch"]), "a CFM bucket above 6"
    return out


class twins_in_dit:
    """Within the block, the DiT's int8 chain runs the plain twins (a
    comparison run: no kernel is launched)."""

    def __enter__(self):
        from gpt_sovits_tpu_torch.models import dit
        from gpt_sovits_tpu_torch.ops import qflash as qf
        from gpt_sovits_tpu_torch.ops import qmatmul as qm

        self.saved = (dit.qdense_int8, dit.qkv_rope_int8, dit.flash_attn_int8, dit.qdense_out_int8)
        dit.qdense_int8, dit.qkv_rope_int8, dit.flash_attn_int8, dit.qdense_out_int8 = (
            qm.qdense_int8_plain, qm.qkv_rope_int8_plain, qf.flash_attn_int8_plain, qm.qdense_out_int8_plain)

    def __exit__(self, *exc):
        from gpt_sovits_tpu_torch.models import dit

        dit.qdense_int8, dit.qkv_rope_int8, dit.flash_attn_int8, dit.qdense_out_int8 = self.saved


def cfm_teacher_phase(pipe, seed: int) -> dict:
    """One full-width CFM chunk (B=1, T=1024 with 1000 real frames, 32
    steps, the same noise) through the kernels and through the twins on the
    card: relative L1 of the mel < 0.02 (the JAX package's int8 bar,
    tests/test_dit_quant.py). Also one chunk under the profiler: device time
    by kernel and the idle share of the call."""
    from gpt_sovits_tpu_torch.models.v3 import cfm_inference

    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    _, _, mel2, t_min = pipe._v3_ref_features()
    dcfg = pipe._dit.cfg
    mu = (0.5 * torch.randn((1, V4_T, dcfg.text_dim), generator=g, device=dev)).to(pipe._cfm_dtype)
    noise = torch.randn((1, V4_T, dcfg.mel_dim), generator=g, device=dev)
    lens = torch.tensor([V4_REAL], device=dev)

    def cfm(_=0):
        return cfm_inference(pipe._dit, mu, lens, mel2, noise=noise, n_steps=32, pad_t_to=pipe.pad_t_to).float()

    got = cfm()
    with twins_in_dit():
        ref = cfm()
    rl1 = float((got[:, t_min:V4_REAL] - ref[:, t_min:V4_REAL]).abs().mean() / ref[:, t_min:V4_REAL].abs().mean())
    assert np.isfinite(rl1) and rl1 < 0.02, rl1
    prof = profile_steps(cfm, steps=2)
    return {"rel_l1": rl1, "mel_abs_mean": float(ref[:, t_min:V4_REAL].abs().mean()), "cfm_call": prof}


# ---------------------------------------------------------------------------
# v3: K6 (csrc/snake_aa.cu, also standing for K7) and K4 (csrc/qmatmul.cu)
# ---------------------------------------------------------------------------

# BigVGAN's stage shapes for a 2224-frame mel, 4 CFM chunks of 556 frames
# (path_v3's batched request when both segments run to the 10 s cap; S1 may
# stop one earlier): (channels, samples) after each upsample of
# BigVGANConfig(); every resblock activation of a stage has that shape (18 of
# them), and activation_post the last one's. (768, 8896) ... (24, 569344).
V3_MEL = 2224
V3_STAGES = tuple((1536 // 2 ** (i + 1), V3_MEL * int(np.prod((4, 4, 2, 2, 2, 2)[: i + 1]))) for i in range(6))
V3_SNAKES_PER_STAGE = 18  # 3 resblocks x 3 dilations x 2 activations
SNAKE_PER_CALL = V3_SNAKES_PER_STAGE * len(V3_STAGES) + 1  # 109 launches per BigVGAN call
# f32 operations an output, an FMA counted as two: 6 FMAs for each of two
# upsampled samples, two snakes (a u, sin, square, one FMA), 12 FMAs for y
SNAKE_OPS = 2 * 6 * 2 + 2 * 5 + 12 * 2
SNAKE_SRC = "gpt_sovits_tpu_torch/csrc/snake_aa.cu"
# rows off a 16-byte boundary (T % 8 != 0), and T shorter than a thread's 8 outputs
SNAKE_RAGGED = ((768, 8897), (24, 569347), (768, 1), (768, 3), (768, 7), (768, 13))
SNAKE_REPLACES = "gpt_sovits_tpu/ops/pallas/snake_aa.py:428 (K6 snake_aa_fused; also :301, K7 snake_aa_folded)"
K4_REPLACES = "gpt_sovits_tpu/ops/pallas/qmatmul.py:346"
K4_T, K4_REAL = 2560, 2500  # a DiT chunk past MAX_INT8_T: T 2560, 2500 real frames


def _snake_misses(got, ref, rtol):
    """Where |got - ref| exceeds 2e-5 + rtol |ref| (elementwise), and by how much."""
    got, ref = got.float(), ref.float()
    return (got - ref).abs() - (2e-5 + rtol * ref.abs())


def snake_case(c: int, t: int, dtype, g: torch.Generator, timed: bool = True, slow: bool = False) -> dict:
    """K6 at one (1, C, T) shape, held elementwise within 2e-5 + rtol |ref|
    of its twin over the whole row and over its first and last 8 samples on
    their own: x of amplitude 5-20 (|a u| in the tens), alpha and beta that
    differ per channel. With `slow`, the kernel is given a reduction range
    of 0, so that every warp takes its path for |a u| beyond the range
    (chunk_any_z: sinf), which no input of well-conditioned size reaches
    otherwise. Where T is not a multiple of 8 (bf16) or 4 (f32),
    rows start off a 16-byte boundary and take the kernel's scalar head and
    tail; T below 8 is shorter than a thread's chunk. On the twin, the share
    of outputs at which a channel fault (the next channel's parameters) or,
    from T = 16, an edge fault (the interior formula carried on through x,
    first 3 samples) would miss the bar. Timed where `timed`."""
    from gpt_sovits_tpu_torch.ops import snake_aa as sa

    dev = torch.device("cuda")
    amp = 5.0 + 15.0 * torch.rand((1, c, 1), generator=g, device=dev)
    x = (torch.randn((1, c, t), generator=g, device=dev) * amp).to(dtype).contiguous()
    alpha = (0.5 * torch.randn(c, generator=g, device=dev)).contiguous()
    beta = (0.5 * torch.randn(c, generator=g, device=dev)).contiguous()
    # rtol 1e-4 in f32 (the JAX tests' bar); one bf16 step (2^-7) in bf16, where
    # both sides round an f32 result that differs in its last bits
    rtol = 1e-4 if dtype == torch.float32 else 2.0**-7
    consts = sa._CONSTS
    if slow:
        sa._CONSTS = (type(consts))(*consts)
        sa._CONSTS[sa.TAPS + 4] = 0.0  # the reduction's |z| limit (ops/snake_aa.py _consts)
    try:
        got, ref = sa.snake_aa(x, alpha, beta), sa.snake_aa_plain(x, alpha, beta)
    finally:
        sa._CONSTS = consts
    miss = _snake_misses(got, ref, rtol)
    err = (got.float() - ref.float()).abs()
    held = {"max_abs_err": float(err.max()), "out_max": float(ref.float().abs().max()),
            "edge_max_abs_err": float(torch.cat([err[..., :8], err[..., -8:]], -1).max()),
            "excess": float(miss.max()), "edge_excess": float(torch.cat([miss[..., :8], miss[..., -8:]], -1).max())}
    assert held["excess"] <= 0 and held["edge_excess"] <= 0, f"snake_aa {dtype} ({c}, {t}) disagrees: {held}"
    x32 = x.float()
    ref32 = sa.snake_aa_plain(x32, alpha, beta)
    shifted = sa.snake_aa_plain(x32, alpha.roll(1), beta.roll(1))
    held["channel_fault_miss_share"] = float((_snake_misses(shifted, ref32, rtol) > 0).float().mean())
    through_x = sa.snake_aa_plain(torch.nn.functional.pad(x32, (8, 8), mode="replicate"), alpha, beta)[..., 8:-8]
    held["edge_fault_miss_share"] = float((_snake_misses(through_x, ref32, rtol)[..., :3] > 0).float().mean())
    assert held["channel_fault_miss_share"] > 0.01 and (t < 16 or held["edge_fault_miss_share"] > 0), held
    out = dict(held=held, config=f"(1, {c}, {t}) {str(dtype)[6:]}" + (", every warp on its sinf path" if slow else ""))
    if timed:
        bound, by = bound_ms(2 * x.numel() * x.element_size() + 8 * c, SNAKE_OPS * x.numel(), "f32")
        out.update(**timings("", lambda i: sa.snake_aa(x, alpha, beta), 20),
                   **timings("plain_", lambda i: sa.snake_aa_plain(x, alpha, beta), 3),
                   library_ms=None, bound_ms=bound, bound_by=by)
    return out


def k4_call(b: int, g: torch.Generator):
    """K4's inputs at (B, 16, 2560, 64) -> 1024 with 2500 real frames: heads
    of very different scales, pad rows 50x larger, mask, gated residual.
    Returns call(fn, a=attn) and attn, res, the weights."""
    dev = torch.device("cuda")
    t, d = K4_T, V4_DIM
    scale = torch.logspace(-1, 1, V4_HEADS, device=dev)[None, :, None, None]
    attn = torch.randn((b, V4_HEADS, t, V4_DH), generator=g, device=dev) * scale
    attn[:, :, K4_REAL:] *= 50.0
    attn = attn.to(torch.bfloat16).contiguous()
    mask = torch.zeros((b, t), device=dev)
    mask[:, :K4_REAL] = 1.0
    res = torch.randn((b, t, d), generator=g, device=dev).to(torch.bfloat16)
    gate = (0.5 * torch.randn((b, d), generator=g, device=dev)).contiguous()
    w = _qweight(d, d, g)
    return (lambda fn, a=attn: fn(a, *w, res_gate_mask=(res, gate, mask))), attn, res, w


def k4_case(b: int, g: torch.Generator) -> dict:
    """K4 at (B, 16, 2560, 64) -> 1024 with 2500 real frames: heads of very
    different scales (a head-order or layout fault moves every row), pad rows
    50x larger with the mask on (the pad rows must carry the residual
    alone); what merging the heads in reverse order would cost is measured
    on the twin. Library: torch._int_mm on the same int8 shapes."""
    from gpt_sovits_tpu_torch.ops import qmatmul as qm

    dev = torch.device("cuda")
    t, d = K4_T, V4_DIM
    call, attn, res, w = k4_call(b, g)
    got, ref = call(qm.qdense_out_int8), call(qm.qdense_out_int8_plain)
    held = {"masked": _held("qdense_out_int8", got, ref)}
    assert float((got[:, K4_REAL:].float() - res[:, K4_REAL:].float()).abs().max()) <= 1e-2, "mask ignored"
    held["plain"] = _held("qdense_out_int8 (no epilogue)", qm.qdense_out_int8(attn, *w), qm.qdense_out_int8_plain(attn, *w))
    rev = call(qm.qdense_out_int8_plain, attn.flip(1).contiguous())
    held["head_order_shift"] = float((rev.float() - ref.float()).abs()[:, :K4_REAL].max())
    assert held["head_order_shift"] > 10 * V4_BAR * held["masked"]["out_max"], held
    m = b * t
    xq_lib = torch.randint(-127, 128, (m, d), generator=g, device=dev, dtype=torch.int8)
    nbytes = m * d * 2 + d * d + 8 * d + 2 * m * d * 2 + b * d * 4 + m * 4
    bound, by = bound_ms(nbytes, 2 * m * d * d, "int8")
    return dict(max_abs_err=held["masked"]["max_abs_err"], held=held,
                **timings("", lambda i: call(qm.qdense_out_int8), 20, split=True),
                **timings("plain_", lambda i: call(qm.qdense_out_int8_plain), 3),
                **timings("library_", lambda i: torch._int_mm(xq_lib, w[0].t()), 20),
                bound_ms=bound, bound_by=by,
                config=f"B={b}, (B, 16, {t}, 64) -> 1024, {K4_REAL} real frames; ms includes row_quant_heads "
                       "(helper_ms), body_ms is the GEMM")


def v3_kernel_phase(seed: int) -> dict:
    """K6 at every BigVGAN stage shape of a 2224-frame mel in bf16 and f32,
    timed, and at SNAKE_RAGGED's shapes and at (768, 8897) on the kernel's
    sinf path, held only; K4 at B = 1 and 4; one
    line each. Returns the rows by (name, config)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for c, t in V3_STAGES + SNAKE_RAGGED:
            r = snake_case(c, t, dtype, g, timed=(c, t) in V3_STAGES)
            emit({"phase": "v3_kernels", "kernel": "snake_aa", **r})
            rows[("snake_aa", dtype, c, t)] = r
            torch.cuda.empty_cache()
        emit({"phase": "v3_kernels", "kernel": "snake_aa", **snake_case(768, 8897, dtype, g, timed=False, slow=True)})
    for b in (1, 4):
        r = k4_case(b, g)
        emit({"phase": "v3_kernels", "kernel": "qdense_out_int8", "B": b, **r})
        rows[("qdense_out_int8", b)] = r
    return rows


def build_v3_pipeline(seed: int):
    """v3 at full width, random weights from the seed: S1Config(), the v3
    SynthesizerTrnV3 (DiT 22 x 1024, 16 heads), BigVGAN (1536 channels,
    x256), AP-BWE (512 x 8, 24 -> 48 kHz), CNHuBERT."""
    from gpt_sovits_tpu_torch.infer.pipeline import V3Bundle, serving_t_chunk
    from gpt_sovits_tpu_torch.models.apbwe import APBWEConfig, APNetBWE
    from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
    from gpt_sovits_tpu_torch.utils.config import MEL_V3

    torch.manual_seed(seed)
    bundle = V3Bundle(
        model=SynthesizerTrnV3(s2_config_for_version("v3")), vocoder=BigVGAN(BigVGANConfig()),
        sr_model=APNetBWE(APBWEConfig()), mel_cfg=MEL_V3, t_ref=468, t_chunk=serving_t_chunk("v3", "cuda"),
        out_sr=24000, sample_steps=32,
    )
    return TTSPipeline(s1_model=T2SDecoder(S1Config()), s2_model=None, hubert_model=HubertEncoder(), v3_bundle=bundle)


V3_MAX_SEC = 10  # 250 tokens, 937 mel frames a segment: two segments are 4 CFM chunks of 556, a 2224-frame mel
V3_TEXT = "Hello there, this is a short test of the flow matching path."
V3_PER_CFM_CALL = {**V4_PER_CFM_CALL, "row_quant_heads": 0, "qdense_out_int8": 0}  # T 1024: K5, not K4


def _apbwe_len(n: int) -> int:
    """Samples out of AP-BWE for n at 24 kHz: x2, then hop 240 x (frames - 1)."""
    return 240 * (2 * n // 240)


def path_v3_phase(pipe, seed: int) -> dict:
    """The full-width v3 requests: (a) a batched run at 24 kHz (one CFM call
    over the chunks of 2 segments, one vocoder call), (b) the serial branch
    with AP-BWE at 48 kHz, (c) run_streaming. Lengths and rates from the S1
    token counts. Returns the CFM and vocoder calls they made, and the
    frames of (a)'s vocoder call."""
    t0 = time.perf_counter()
    pipe.set_ref_audio(reference_wav(seed), sr=32000, ref_text="This is the reference voice speaking clearly.")
    pipe._v3_ref_features()
    torch.cuda.synchronize()
    emit({"phase": "path_v3", "event": "set_ref_audio", "s": time.perf_counter() - t0,
          "prompt_tokens": int(len(pipe.ref.prompt_semantic)), "dit_quant": pipe.dit_quant, "t_chunk": pipe.v3.t_chunk})
    up = 256
    silence24, silence48 = int(24000 * pipe.cfg.fragment_interval), int(48000 * pipe.cfg.fragment_interval)
    calls = {"cfm": 0, "vocoder": 0}

    def record(name, wall, audio_s, extra):
        rec = {"phase": "path_v3", "request": name, "tokens": list(pipe.last_tokens.values()),
               "cfm_batch": [list(b) for b in pipe.last_cfm_batch], "audio_s": audio_s, "wall_s": wall,
               "rtf": wall / audio_s, **extra}
        emit(rec)
        calls["cfm"] += len(pipe.last_cfm_batch)
        return rec

    # (a) batched, 24 kHz
    t0 = time.perf_counter()
    sr, audio = pipe.run(V3_TEXT, "en", seed=seed, max_sec=V3_MAX_SEC, super_sampling=False)
    wall = time.perf_counter() - t0
    frames = [pipe._mel_len_for(n, 1.0) for n in pipe.last_tokens.values()]
    assert sr == 24000 and audio.dtype == np.int16 and len(frames) == 2, (sr, audio.dtype, frames)
    assert audio.shape == (sum(f * up for f in frames) + silence24,), (audio.shape, frames)
    chunk_len = pipe.v3.t_chunk - pipe._v3_ref_features()[3]
    bs, _, bs_pad = v3_chunk_plan(sum(frames), chunk_len, pipe.v3.overlapped_len)
    assert pipe.last_cfm_batch == [(bs, bs_pad)] and bs > 1, (pipe.last_cfm_batch, bs, bs_pad)  # a multi-chunk batch
    calls["vocoder_frames"] = bs_pad * chunk_len  # the batched vocoder call's mel
    rec = record("batched_24k", wall, len(audio) / sr, {"phases_s": pipe.last_timing,
                                                         "vocoder_frames": calls["vocoder_frames"]})
    calls["vocoder"] += len(rec["cfm_batch"])
    assert np.isfinite(audio.astype(np.float32)).all()

    # (b) serial, AP-BWE to 48 kHz
    t0 = time.perf_counter()
    sr, audio = pipe.run(V3_TEXT, "en", seed=seed, max_sec=V3_MAX_SEC, parallel_infer=False, super_sampling=True)
    wall = time.perf_counter() - t0
    frames = [pipe._mel_len_for(n, 1.0) for n in pipe.last_tokens.values()]
    assert sr == 48000 and audio.dtype == np.int16 and len(frames) == 2
    assert audio.shape == (sum(_apbwe_len(f * up) for f in frames) + silence48,), (audio.shape, frames)
    assert len(pipe.last_cfm_batch) == sum(-(-f // chunk_len) for f in frames) > len(frames)  # rolling chunks
    record("serial_48k", wall, len(audio) / sr, {"phases_s": pipe.last_timing})
    calls["vocoder"] += len(frames)

    # (c) streaming (serial branch), 24 kHz
    t0 = time.perf_counter()
    frags = list(pipe.run_streaming(V3_TEXT, "en", seed=seed, max_sec=V3_MAX_SEC, super_sampling=False))
    wall = time.perf_counter() - t0
    frames = [pipe._mel_len_for(n, 1.0) for n in pipe.last_tokens.values()]
    assert [f[0] for f in frags] == [24000] * len(frames) == [24000, 24000]
    assert [len(f[1]) for f in frags] == [n * up + silence24 for n in frames], ([len(f[1]) for f in frags], frames)
    assert 0 < pipe.last_ttfb < wall
    record("streaming_24k", wall, sum(len(f[1]) for f in frags) / 24000,
           {"fragments": len(frags), "ttfb_s": pipe.last_ttfb})
    calls["vocoder"] += len(frames)
    return calls


def _v3_mel(pipe, seed: int) -> torch.Tensor:
    """A 2224-frame mel in the vocoder's dtype, from the seed."""
    g = torch.Generator(device=pipe.device).manual_seed(seed + 50)
    mel = (2.0 * torch.randn((1, V3_MEL, pipe.v3.mel_cfg.num_mels), generator=g, device=pipe.device) - 6.0)
    return mel.to(pipe._voc_dtype)


def v3_layer_profiles(pipe, seed: int) -> dict:
    """One BigVGAN call on a 2224-frame mel (bf16) and one AP-BWE call on
    10 s of 24 kHz audio, under the profiler: device time by kernel and the
    share of the wall time the device sat idle."""
    from gpt_sovits_tpu_torch.models.apbwe import super_resolve

    mel = _v3_mel(pipe, seed)
    wav = (0.1 * np.random.default_rng(seed).standard_normal((1, 240000))).astype(np.float32)
    with torch.no_grad():
        return {"bigvgan_2224_frames": profile_steps(lambda i: pipe._voc(mel), steps=2),
                "apbwe_10s": profile_steps(lambda i: super_resolve(pipe.v3.sr_model, wav, 24000), steps=2)}


class twins_in_bigvgan:
    """Within the block, BigVGAN's snakes run the plain twin (a comparison
    run: no K6 launch)."""

    def __enter__(self):
        from gpt_sovits_tpu_torch.models import bigvgan
        from gpt_sovits_tpu_torch.ops import snake_aa as sa

        self.saved, bigvgan.snake_aa = bigvgan.snake_aa, sa.snake_aa_plain

    def __exit__(self, *exc):
        from gpt_sovits_tpu_torch.models import bigvgan

        bigvgan.snake_aa = self.saved


def snake_in_call(pipe, seed: int, steps: int = 2) -> dict:
    """K6 inside one BigVGAN call of the v3 pipeline on a 2224-frame mel
    (bf16), under the profiler. ms: the device time of the call's 109 K6
    launches. plain_ms: the device time the twins take in their place, that
    is the call's device time with the twins less its device time without
    K6's launches. The bound counts the bytes and operations of the snake
    inputs this call made, recorded by a forward pre-hook."""
    from gpt_sovits_tpu_torch.models.bigvgan import AntiAliasedSnake
    from gpt_sovits_tpu_torch.ops import snake_aa as sa

    mel = _v3_mel(pipe, seed)
    seen = []
    hooks = [m.register_forward_pre_hook(lambda _m, a: seen.append((a[0].numel(), a[0].element_size(), a[0].shape[1])))
             for m in pipe._voc.modules() if isinstance(m, AntiAliasedSnake)]
    try:
        with torch.no_grad():
            pipe._voc(mel)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == SNAKE_PER_CALL, len(seen)
    bound, by = bound_ms(sum(2 * n * e + 8 * c for n, e, c in seen), SNAKE_OPS * sum(n for n, _, _ in seen), "f32")

    def call(_=0):
        return pipe._voc(mel)

    def snake_launches(evs):
        return sum(ev.count for ev in evs if "snake_aa_kernel" in ev.key) / steps

    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        sa.reset_launch_counts()
        call()
        counted = sa.launch_counts()["snake_aa"]
        # a window in which the profiler dropped one of K6's launches would
        # read its time short: such a window is taken again
        evs = device_events(call, steps, attempts=6, complete=lambda e: snake_launches(e) == SNAKE_PER_CALL)
        wall = cuda_ms(call, steps)
        with twins_in_bigvgan():
            call()
            torch.cuda.synchronize()
            evs_t, wall_t = device_events(call, steps), cuda_ms(call, steps)
    assert counted == SNAKE_PER_CALL, f"K6 launched {counted} times in one BigVGAN call"
    assert evs, f"the profiler saw no whole window of the BigVGAN call's {SNAKE_PER_CALL} K6 launches"
    assert evs_t, "the profiler saw no device time in the twins' BigVGAN call"
    snake = [ev for ev in evs if "snake_aa_kernel" in ev.key]
    assert not any("snake_aa_kernel" in ev.key for ev in evs_t), "K6 launched in the twins' call"
    launches = snake_launches(evs)
    ms = sum(ev.self_device_time_total for ev in snake) / 1e3 / steps
    busy = sum(ev.self_device_time_total for ev in evs) / 1e3 / steps
    busy_t = sum(ev.self_device_time_total for ev in evs_t) / 1e3 / steps
    return {"ms": ms, "plain_ms": busy_t - (busy - ms), "bound_ms": bound, "bound_by": by, "timer": "profiler",
            "launches_a_call": launches, "call_device_ms": busy, "call_device_ms_twins": busy_t,
            "call_wall_ms": wall, "call_wall_ms_twins": wall_t}


def cfm_long_phase(pipe, seed: int, steps: int = 4) -> dict:
    """One full-width CFM call past MAX_INT8_T (B=1, T=2560 with 2500 real
    frames, a few Euler steps) through K3 -> SDPA -> K4 -> K2 and through
    the twins on the card: relative L1 of the mel < 0.02 (the JAX package's
    int8 bar, tests/test_dit_quant.py). K4 launches once a block a step."""
    from gpt_sovits_tpu_torch.models.v3 import cfm_inference

    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    _, _, mel2, t_min = pipe._v3_ref_features()
    dcfg = pipe._dit.cfg
    mu = (0.5 * torch.randn((1, K4_T, dcfg.text_dim), generator=g, device=dev)).to(pipe._cfm_dtype)
    noise = torch.randn((1, K4_T, dcfg.mel_dim), generator=g, device=dev)
    lens = torch.tensor([K4_REAL], device=dev)

    def cfm():
        return cfm_inference(pipe._dit, mu, lens, mel2, noise=noise, n_steps=steps, pad_t_to=pipe.pad_t_to).float()

    reset_all_launch_counts()
    got = cfm()
    torch.cuda.synchronize()
    launches = all_launch_counts()
    per_block_step = dcfg.depth * steps
    expect = {"qkv_rope_int8": per_block_step, "row_quant_heads": per_block_step, "qdense_out_int8": per_block_step,
              "qdense_int8": 2 * per_block_step, "row_quant": 3 * per_block_step, "flash_attn_int8": 0, "v_quant": 0}
    assert all(launches[k] == v for k, v in expect.items()), (launches, expect)
    with twins_in_dit():
        ref = cfm()
    sl = slice(t_min, K4_REAL)
    rl1 = float((got[:, sl] - ref[:, sl]).abs().mean() / ref[:, sl].abs().mean())
    assert np.isfinite(rl1) and rl1 < 0.02, rl1
    return {"rel_l1": rl1, "mel_abs_mean": float(ref[:, sl].abs().mean()), "T": K4_T, "real": K4_REAL,
            "steps": steps, "launches": {k: launches[k] for k in expect}}


def stream_v2_phase(pipe, seed: int) -> dict:
    """One run_streaming request on the v2ProPlus pipeline: one fragment per
    segment in reading order, each its tokens' length plus the silence."""
    hop_up = int(np.prod(pipe.s2.cfg.upsample_rates))
    sr = pipe.mel_cfg.sampling_rate
    silence = int(sr * pipe.cfg.fragment_interval)
    t0 = time.perf_counter()
    frags = list(pipe.run_streaming(REQUESTS[1], "en", seed=seed, max_sec=MAX_SEC))
    wall = time.perf_counter() - t0
    tokens = list(pipe.last_tokens.values())
    assert len(frags) == len(tokens) > 1 and all(f[0] == sr and f[1].dtype == np.int16 for f in frags)
    assert [len(f[1]) for f in frags] == [n * 2 * hop_up + silence for n in tokens], ([len(f[1]) for f in frags], tokens)
    assert 0 < pipe.last_ttfb < wall
    return {"fragments": len(frags), "tokens": tokens, "ttfb_s": pipe.last_ttfb, "wall_s": wall,
            "audio_s": sum(len(f[1]) for f in frags) / sr}


# ---------------------------------------------------------------------------
# serving: the continuous-batching slot pool on K1, the service, HTTP
# ---------------------------------------------------------------------------

POOL = dict(slots=8, tx_max=512, tp_max=512, max_new=300)  # the service's layout, a 12 s cap a segment
SEGMENT = 25
GREEDY = dict(top_k=1, top_p=1.0, temperature=1.0)
# per-request sampling of the serve_v2 waves: request i takes SERVE_MIX[i % 4]
SERVE_MIX = [dict(top_k=1), dict(top_k=5, temperature=1.0), dict(top_k=15, temperature=0.7),
             dict(top_k=5, temperature=0.7)]
POOL_BAR = 0.05  # relative L2 error of a pool row's K/V against its reference: int8 KV (and W8A8) put it near 0.01


def _dequant(kv: torch.Tensor, scales: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 K||V (L, n, 2D) with scales (L, 2, n) -> K, V (L, n, D) f32."""
    return kv[..., :D].float() * scales[:, 0, :, None], kv[..., D:].float() * scales[:, 1, :, None]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


@torch.no_grad()
def pool_layout_phase(pipe) -> dict:
    """A full-width pool (8 slots, int8 weights and KV, the service's
    layout) that admits three requests at different steps (10, 7 and 5
    steps apart), read mid-decode. Each row's mask marks exactly its
    left-padded phones, its prompt and its generated tokens' slots; its
    prefix K/V at every layer equals the request's own prefill, and its
    generated tokens' K/V at layer 0 their projection, within int8's error
    (POOL_BAR); one K1 launch a pool step. A pool that installs or writes a
    row at the wrong slots fails here whatever the tokens. Then, with all 8
    rows installed at different steps, the pool's next step through K1 (its
    host list of write slots, its plan sweep) is held against the twin on
    the pool's own cache, mask and inputs (hold_step)."""
    from gpt_sovits_tpu_torch.infer.continuous import ContinuousBatcher

    m = pipe.s1
    dev = pipe.device
    cb = ContinuousBatcher(m, **POOL, **GREEDY, repetition_penalty=pipe.cfg.repetition_penalty,
                           use_fused=pipe.use_fused_s1, weight_quant=pipe.s1_weight_quant, kv_quant=pipe.s1_kv_quant,
                           fused_weights=pipe._s1_weights, device=dev)
    assert cb.use_fused and cb.kv_quant and cb.plan_sweep == PLAN_SWEEP
    segs = [pipe.preprocess(t, "en")[0] for t in REQUESTS]
    prompt = pipe.ref.prompt_semantic
    ds.reset_launch_counts()
    slots = []
    for seg, n in zip(segs, (10, 7, 5)):  # admitted at different steps, no eviction in between
        cb.submit(seg["phones"], seg["bert"], prompt)
        cb._admit_batch()
        slots.append(cb._slot_rid.index(cb._next_rid - 1))
        cb._segment(n)
    torch.cuda.synchronize()
    launches = ds.launch_counts()["fused_decode_step"]
    assert launches == cb.steps_run == 22, (launches, cb.steps_run)
    st = cb.state
    scratch, n_p = cb.scratch, len(prompt)
    rows = []
    for seg, slot in zip(segs, slots):
        g, done = int(st.gen_count[slot]), bool(st.done[slot])
        n_gen = g if done else g - 1  # tokens whose K/V is in the cache
        n_ph = len(seg["phones"])
        want = torch.zeros(cb.t_total, dtype=torch.bool, device=dev)
        want[POOL["tx_max"] - n_ph : POOL["tx_max"]] = True
        want[POOL["tx_max"] : POOL["tx_max"] + n_p] = True
        want[scratch : scratch + n_gen] = True
        assert torch.equal(st.mask[slot] > 0, want), f"slot {slot}: the mask marks other slots than the row's"
        phones = torch.tensor([seg["phones"]], device=dev)
        p_ids = torch.from_numpy(prompt[None].astype(np.int64)).to(dev)
        x_emb = m.embed_text(phones, torch.zeros((1, n_ph, m.cfg.bert_dim), device=dev),
                             torch.arange(n_ph, device=dev)[None])
        p_emb = m.embed_audio(p_ids, torch.arange(n_p, device=dev)[None])
        ones = lambda n: torch.ones((1, n), dtype=torch.bool, device=dev)  # noqa: E731
        _, k_ref, v_ref = m.prefill(torch.cat([x_emb, p_emb], 1), build_prefix_attn_bias(ones(n_ph), ones(n_p)))
        idx = torch.nonzero(want[:scratch])[:, 0]
        k, v = _dequant(st.kv[:, slot, idx], st.kv_scales[:, slot, :, idx])
        err_prefix = max(_rel(k, k_ref.reshape(L, -1, D)), _rel(v, v_ref.reshape(L, -1, D)))
        toks = st.tokens[slot, :n_gen]
        x = m.embed_audio(toks[None], (n_p + torch.arange(n_gen, device=dev))[None])
        qkv = torch.nn.functional.linear(x, m.h.layers[0].self_attn.in_proj_weight,
                                         m.h.layers[0].self_attn.in_proj_bias)[0]
        k, v = _dequant(st.kv[:1, slot, scratch : scratch + n_gen], st.kv_scales[:1, slot, :, scratch : scratch + n_gen])
        err_gen = max(_rel(k[0], qkv[:, D : 2 * D]), _rel(v[0], qkv[:, 2 * D :]))
        rows.append({"slot": slot, "tokens": g, "done": done, "err_prefix": err_prefix, "err_generated_l0": err_gen})
        assert err_prefix < POOL_BAR and err_gen < POOL_BAR, rows[-1]
    # the pool step alone, all 8 rows live: wall a step (the host's enqueue
    # rate), device time a step and its kernels
    for i in range(POOL["slots"] - len(segs)):
        seg = segs[i % len(segs)]
        cb.submit(seg["phones"], seg["bert"], prompt)
    cb._admit_batch()
    assert all(r is not None for r in cb._slot_rid)
    # the next step's write slots by the pool's rule (_segment): the token sampled g - 1 steps ago
    slots = (cb.scratch + np.maximum(cb._count - 1, 0)).tolist()
    assert len(set(slots)) > 3, slots
    e_abs, e_rel = hold_step(cb.fused_weights, "int8", st.kv, st.kv_scales, st.mask, st.tok_emb[:, 0].contiguous(),
                             slots, plan_sweep=cb.plan_sweep)
    held = {"slots": slots, "plan": ds.step_plan(max(slots), True, cb.plan_sweep), "max_abs_err": e_abs,
            "rel_err": e_rel}
    step = profile_steps(lambda i: cb._segment(1), steps=25)
    del cb, st
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": 22, "rows": rows, "bar": POOL_BAR, "step_vs_twin": held, "step_b8": step}


def generate_at_pool_layout(pipe, seg: dict, prompt: np.ndarray) -> np.ndarray:
    """Greedy `generate` through K1 at B=1 on one segment, laid out as the
    pool lays a row out (phones left-padded to tx_max, prompt right-padded
    to tp_max), so that K1's split plan is the pool's."""
    dev = pipe.device
    tx, tp, n_ph = POOL["tx_max"], POOL["tp_max"], len(seg["phones"])
    phones = torch.zeros((1, tx), dtype=torch.long, device=dev)
    phones[0, tx - n_ph :] = torch.tensor(seg["phones"], device=dev)
    prompt_t = torch.zeros((1, tp), dtype=torch.long, device=dev)
    prompt_t[0, : len(prompt)] = torch.from_numpy(prompt.astype(np.int64)).to(dev)
    out = generate(
        pipe.s1, phones, torch.tensor([n_ph], device=dev), torch.zeros((1, tx, pipe.s1.cfg.bert_dim), device=dev),
        prompt_t, torch.tensor([len(prompt)], device=dev), None, max_new_tokens=POOL["max_new"], **GREEDY,
        repetition_penalty=pipe.cfg.repetition_penalty, use_fused_kernel=True, weight_quant=pipe.s1_weight_quant,
        kv_cache_quant=pipe.s1_kv_quant, fused_weights=pipe._s1_weights,
    )
    return out.tokens[0, : int(out.lengths[0])].cpu().numpy()


def k1_reference_tokens(pipe, seg: dict, prompt: np.ndarray) -> np.ndarray:
    """One segment decoded greedily at B=1 by the pool's rule, written out
    apart from the pool: the prefill at the pool's layout, the first logits
    from the plain decode step on the f32 rows, the rows quantized once,
    then K1 steps (the pool's split plan) with the mask from before each
    update, and filter_logits with the pipeline's penalty. `generate` takes
    its first logits from K1 instead, so a near-tie can part it from the
    pool at token 0."""
    m, dev = pipe.s1, pipe.device
    cfg = m.cfg
    eos = cfg.eos_id
    tx, tp, max_new = POOL["tx_max"], POOL["tp_max"], POOL["max_new"]
    scratch = tx + tp
    t_total = -(-(scratch + 1 + max_new) // 512) * 512
    n_ph, n_p = len(seg["phones"]), len(prompt)
    phones = torch.zeros((1, tx), dtype=torch.long, device=dev)
    phones[0, tx - n_ph :] = torch.tensor(seg["phones"], device=dev)
    prompt_t = torch.zeros((1, tp), dtype=torch.long, device=dev)
    prompt_t[0, :n_p] = torch.from_numpy(prompt.astype(np.int64)).to(dev)
    ar_x, ar_p = torch.arange(tx, device=dev)[None], torch.arange(tp, device=dev)[None]
    x_valid, p_valid = ar_x >= tx - n_ph, ar_p < n_p
    kw = dict(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=pipe.cfg.repetition_penalty)
    with torch.no_grad():
        x_emb = m.embed_text(phones, torch.zeros((1, tx, cfg.bert_dim), device=dev),
                             torch.clamp(ar_x - (tx - n_ph), min=0)) * x_valid[..., None]
        p_emb = m.embed_audio(prompt_t, ar_p) * p_valid[..., None]
        _, k, v = m.prefill(torch.cat([x_emb, p_emb], 1), build_prefix_attn_bias(x_valid, p_valid))
        pad = t_total - scratch
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).contiguous()
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).contiguous()
        valid = torch.cat([x_valid, p_valid, torch.zeros((1, pad), dtype=torch.bool, device=dev)], 1)
        last = prompt_t[:, n_p - 1 : n_p]
        logits = m.decode_step(m.embed_audio(last, torch.full_like(last, n_p - 1)), k, v, valid, scratch).float()
        kv, kv_s = ds.quantize_kv_cache(torch.cat([k.reshape(L, 1, t_total, D), v.reshape(L, 1, t_total, D)],
                                                  -1).to(torch.bfloat16))
        mask = valid.float()
        presence = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device=dev)
        presence[0, prompt_t[0, :n_p]] = True
        presence[0, eos] = False
        head = m.ar_predict_layer.weight.float()
        logits[:, eos] = float("-inf")
        tok = filter_logits(logits, presence, **kw).argmax(-1)
        toks, c = [int(tok)], 1
        while True:
            presence[0, tok] = True
            emb = m.embed_audio(tok[:, None], torch.tensor([[n_p + c - 1]], device=dev))
            y = ds.fused_decode_step(emb[:, 0].contiguous(), pipe._s1_weights, kv, mask, scratch + c - 1, kv_s,
                                     num_heads=H, plan_sweep=scratch + max_new)[0]
            mask[0, scratch + c - 1] = 1.0
            logits = torch.nn.functional.linear(y, head)
            if c < EOS_MASK_WARMUP_STEPS:
                logits[:, eos] = float("-inf")
            tok = filter_logits(logits, presence, **kw).argmax(-1)
            if int(logits.argmax(-1)) == eos or int(tok) == eos or c >= max_new:
                return np.asarray(toks)
            toks.append(int(tok))
            c += 1


def agreement(a: np.ndarray, b: np.ndarray) -> float:
    n = min(len(a), len(b))
    return float((a[:n] == b[:n]).sum() / max(len(a), len(b), 1))


def serve_v2_phase(pipe, seed: int):
    """The continuous service on the v2ProPlus pipeline: the pool layout
    check (pool_layout_phase), then 12 requests from threads in three waves
    of 4 (REQUESTS, SERVE_MIX sampling, a seed each). Held: each request's
    int16 audio is finite and its tokens x 2 x the hop long plus the
    silences; K1's launches, counted in the CUDA code, equal the pool's
    steps; the pool held more than one live row at once; each greedy
    request's tokens agree >= 0.9 on each segment with `generate` through
    K1 at B=1 at the pool's layout and with a B=1 K1 decode by the pool's
    own rule (k1_reference_tokens); one sampled, seeded request sent again
    alone gives the same tokens (K1's split plan is fixed per pool, so co-tenants do not change
    a row's rounding). Returns (record, service): the service stays up for
    the http phase."""
    from gpt_sovits_tpu_torch.serve.continuous_service import ContinuousTTSService

    layout = pool_layout_phase(pipe)
    emit({"phase": "serve_v2", "event": "pool_layout", **layout})
    t0 = time.perf_counter()
    svc = ContinuousTTSService(pipe, segment=SEGMENT, **POOL)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    hop = 2 * int(np.prod(pipe.s2.cfg.upsample_rates))
    sr = pipe.mel_cfg.sampling_rate
    silence = int(sr * pipe.cfg.fragment_interval)
    reqs = [(REQUESTS[i % len(REQUESTS)], SERVE_MIX[i % len(SERVE_MIX)], seed + 200 + i) for i in range(12)]

    def one(i, out):
        text, sampling, s = reqs[i]
        t = time.perf_counter()
        job = svc.submit(text, "en", seed=s, **sampling)
        _, audio = svc.result(job, timeout=300)
        out[i] = (job, audio, time.perf_counter() - t)

    ds.reset_launch_counts()
    steps0, svc.cb.peak_live = svc.cb.steps_run, 0
    res: dict = {}
    waves = []
    for w in range(3):
        t = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i, res)) for i in range(4 * w, 4 * w + 4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t
        assert not any(th.is_alive() for th in threads) and all(i in res for i in range(4 * w, 4 * w + 4)), w
        audio_s = sum(len(res[i][1]) for i in range(4 * w, 4 * w + 4)) / sr
        waves.append({"wall_s": wall, "audio_s": audio_s, "audio_s_per_s": audio_s / wall})
    while svc.cb.pending:  # the scheduler's last pass
        time.sleep(0.01)
    launches = ds.launch_counts()["fused_decode_step"]
    steps = svc.cb.steps_run - steps0
    assert launches == steps > 0, (launches, steps)
    assert svc.cb.peak_live > 1, svc.cb.peak_live
    segments = 0
    for i, (job, audio, _) in res.items():
        n_tok = [len(job.tokens[r]) for r in job.rids]
        segments += len(n_tok)
        assert audio.dtype == np.int16 and audio.shape == (sum(n_tok) * hop + (len(n_tok) - 1) * silence,), (i, n_tok)
        assert np.isfinite(audio.astype(np.float32)).all()
    prompt = pipe.ref.prompt_semantic
    teacher, vs_generate = {}, {}
    for i, (text, sampling, _) in enumerate(reqs):
        if sampling.get("top_k") == 1:
            job = res[i][0]
            teacher[i] = [agreement(job.tokens[r], k1_reference_tokens(pipe, sg, prompt))
                          for r, sg in zip(job.rids, job.segments)]
            vs_generate[i] = [agreement(job.tokens[r], generate_at_pool_layout(pipe, sg, prompt))
                              for r, sg in zip(job.rids, job.segments)]
            assert min(teacher[i]) >= 0.9 and min(vs_generate[i]) >= 0.9, (i, teacher[i], vs_generate[i])
    # co-tenancy: a sampled, seeded one-segment request again, alone
    i_alone = next(i for i, (text, smp, _) in enumerate(reqs) if smp.get("top_k") != 1 and len(res[i][0].rids) == 1)
    text, sampling, s = reqs[i_alone]
    alone = svc.submit(text, "en", seed=s, **sampling)
    svc.result(alone, timeout=300)
    shared = res[i_alone][0]
    same = all(np.array_equal(alone.tokens[a], shared.tokens[b]) for a, b in zip(alone.rids, shared.rids))
    assert same, "a seeded request's tokens changed with its co-tenants"
    lat = sorted(r[2] for r in res.values())
    total_wall = sum(w["wall_s"] for w in waves)
    rec = {"setup_s": setup_s, "requests": len(res), "segments": segments, "pool_steps": steps, "launches": launches,
           "peak_live": svc.cb.peak_live, "latency_s": {"median": float(np.median(lat)), "max": lat[-1]},
           "waves": waves, "audio_s_per_s": sum(w["audio_s"] for w in waves) / total_wall,
           "greedy_agreement": teacher, "generate_agreement": vs_generate, "cotenancy_same_tokens": same,
           "tokens": {i: [len(r[0].tokens[x]) for x in r[0].rids] for i, r in res.items()},
           "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9}
    return rec, svc


def _http(method: str, url: str, payload: dict | None = None, timeout: float = 300):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _riff_ok(body: bytes, streamed: bool = False) -> bool:
    """A RIFF/WAVE header whose data length is the body's (0 when streamed)."""
    if len(body) < 44 or body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        return False
    n = struct.unpack("<I", body[40:44])[0]
    return n == 0 and len(body) > 44 if streamed else n == len(body) - 44 == struct.unpack("<I", body[4:8])[0] - 36


def http_phase(pipe, svc, seed: int, tmp: str) -> dict:
    """`serve(TTSService(pipe, continuous=svc), port=0)`: 4 concurrent POST
    /tts answer 200 with a RIFF header whose data length matches; one GET
    /tts?streaming_mode=true answers a streamed RIFF; a zh and an auto POST
    answer 200 with RIFF bodies; a made-up text_lang answers 400. The server
    is shut down before the phase ends."""
    from gpt_sovits_tpu_torch.serve.api import TTSService, serve, wav_bytes

    ref = str(Path(tmp) / "ref_v2.wav")
    Path(ref).write_bytes(wav_bytes((reference_wav(seed) * 32767).astype(np.int16), 32000))
    srv = serve(TTSService(pipe, continuous=svc), port=0)
    base = "http://%s:%d" % srv.server_address
    try:
        out: dict = {}

        def post(i):
            t = time.perf_counter()
            code, body = _http("POST", base + "/tts", {"text": REQUESTS[i % len(REQUESTS)], "text_lang": "en",
                                                       "ref_audio_path": ref, "seed": seed + 300 + i})
            out[i] = (code, body, time.perf_counter() - t)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        assert all(i in out and out[i][0] == 200 and _riff_ok(out[i][1]) for i in range(4)), \
            {i: (out[i][0], out[i][1][:200]) for i in out}
        q = urllib.parse.urlencode({"text": REQUESTS[1], "text_lang": "en", "ref_audio_path": ref, "seed": seed,
                                    "streaming_mode": "true"})
        t = time.perf_counter()
        code_s, body_s = _http("GET", base + "/tts?" + q)
        stream_s = time.perf_counter() - t
        assert code_s == 200 and _riff_ok(body_s, streamed=True), (code_s, body_s[:200])
        t = time.perf_counter()
        code_zh, body_zh = _http("POST", base + "/tts", {"text": ZH_REQUESTS[0][0], "text_lang": "zh",
                                                         "ref_audio_path": ref, "seed": seed})
        zh_s = time.perf_counter() - t
        assert code_zh == 200 and _riff_ok(body_zh), (code_zh, body_zh[:300])
        code_auto, body_auto = _http("POST", base + "/tts", {"text": ZH_REQUESTS[2][0], "text_lang": "auto",
                                                             "ref_audio_path": ref, "seed": seed})
        assert code_auto == 200 and _riff_ok(body_auto), (code_auto, body_auto[:300])
        code_xx, body_xx = _http("POST", base + "/tts", {"text": "qapla", "text_lang": "tlh", "ref_audio_path": ref})
        assert code_xx == 400 and b"not supported" in body_xx, (code_xx, body_xx)
    finally:
        srv.shutdown()
        srv.server_close()
    audio_s = sum((len(out[i][1]) - 44) / 2 for i in range(4)) / pipe.mel_cfg.sampling_rate
    return {"posts": [out[i][0] for i in range(4)], "latency_s": [out[i][2] for i in range(4)], "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "stream": {"code": code_s, "bytes": len(body_s), "s": stream_s},
            "zh": {"code": code_zh, "s": zh_s, "audio_s": (len(body_zh) - 44) / 2 / pipe.mel_cfg.sampling_rate},
            "auto": code_auto, "unknown_language": code_xx}


def http_v4_phase(pipe, seed: int, tmp: str) -> dict:
    """One POST /tts through the v4 pipeline's batch branch answers 200
    with a RIFF header whose data length matches."""
    from gpt_sovits_tpu_torch.serve.api import TTSService, serve, wav_bytes

    ref = str(Path(tmp) / "ref_v4.wav")
    Path(ref).write_bytes(wav_bytes((reference_wav(seed) * 32767).astype(np.int16), 32000))
    srv = serve(TTSService(pipe), port=0)
    try:
        t = time.perf_counter()
        code, body = _http("POST", "http://%s:%d/tts" % srv.server_address, {
            "text": V4_REQUESTS[0], "text_lang": "en", "ref_audio_path": ref,
            "prompt_text": "This is the reference voice speaking clearly.", "prompt_lang": "en", "seed": seed,
            "text_split_method": "cut0"})
        wall = time.perf_counter() - t
        assert code == 200 and _riff_ok(body), (code, body[:300])
    finally:
        srv.shutdown()
        srv.server_close()
    return {"code": code, "wall_s": wall, "audio_s": (len(body) - 44) / 2 / 48000}


def serve_case(g: torch.Generator) -> dict:
    """serve_v2 on its own (the broken copies' check): a full-width
    v2ProPlus pipeline from seed 0, its reference, then serve_v2_phase."""
    pipe = build_pipeline(0)
    pipe.set_ref_audio(reference_wav(0), sr=32000)
    rec, svc = serve_v2_phase(pipe, 0)
    svc.close()
    return rec


def kernel_times(seed: int) -> dict:
    """Device ms of K2 (one DiT block's three calls), K4, K5 and K3 at the
    main path's shapes, B = 1 and 4, with body_ms and helper_ms; of K1's
    step at B = 1 in int8 and bf16; and of K6 for one BigVGAN call on a
    2224-frame mel in bf16: each stage shape's time (V3_STAGES) times its
    launches, 18 a stage and one more at the last (activation_post). Only
    the wrappers' public functions are called, with their default options,
    so the same code times another tree's kernels (compare_trees)."""
    from gpt_sovits_tpu_torch.ops import qflash as qf
    from gpt_sovits_tpu_torch.ops import qmatmul as qm
    from gpt_sovits_tpu_torch.ops import snake_aa as sa

    g = torch.Generator(device="cuda").manual_seed(seed + 60)
    sm = 1.0 / np.sqrt(V4_DH)
    out = {}
    for b in (1, 4):
        calls, _ = k2_block(b, V4_T, V4_REAL, g)
        out[f"qdense_int8 B={b}"] = timings("", lambda i: [c(qm.qdense_int8) for c, _, _ in calls.values()], 20,
                                            split=True)
        call = k4_call(b, g)[0]
        out[f"qdense_out_int8 B={b}"] = timings("", lambda i: call(qm.qdense_out_int8), 20, split=True)
        mask, cases = k5_inputs(b, V4_T, V4_REAL, g)
        q, k, v = cases["random"]
        out[f"flash_attn_int8 B={b}"] = timings("", lambda i: qf.flash_attn_int8(q, k, v, mask, sm_scale=sm), 20,
                                                split=True)
        k3 = k3_call(b, V4_T, g)[0]
        out[f"qkv_rope_int8 B={b}"] = timings("", lambda i: k3(qm.qkv_rope_int8), 20, split=True)
        del calls, call, mask, cases, q, k, v, k3
        torch.cuda.empty_cache()
    # K1: one step at B = 1, int8 weights and KV, then bf16 (the function's
    # device time: every kernel the step launches)
    torch.manual_seed(seed)
    state = T2SDecoder(S1Config()).state_dict()
    for quant in ("int8", "bf16"):
        w = {k_: v_.to("cuda") for k_, v_ in ds.stack_weights_from_params(state, L, quant=quant).items()}
        kv_, kv_s, mask_, x = step_inputs(quant, 1, g)
        step = lambda i: ds.fused_decode_step(x, w, kv_, mask_, LIVE, kv_s, num_heads=H)  # noqa: E731
        out[f"fused_decode_step {quant} B=1"] = {**timings("", step, 10), "queued_ms": queued_ms(step, 20)}
        del w, kv_, kv_s
        torch.cuda.empty_cache()
    stages = {}
    for i, (c, t) in enumerate(V3_STAGES):
        x = (torch.randn((1, c, t), generator=g, device="cuda") * 10.0).to(torch.bfloat16)
        alpha, beta = (0.5 * torch.randn(c, generator=g, device="cuda") for _ in range(2))
        n = V3_SNAKES_PER_STAGE + (i == len(V3_STAGES) - 1)
        stages[f"({c}, {t})"] = {"launches": n, **timings("", lambda j: sa.snake_aa(x, alpha, beta), 20)}
    out["snake_aa BigVGAN call"] = {
        f: sum(r[f] * r["launches"] for r in stages.values()) for f in ("ms", "wall_ms")} | {"stages": stages}
    return out


def compare_trees(parent: str, seed: int) -> dict:
    """kernel_times run on the kernels of the tree at `parent` (an unpacked
    `git archive` of an earlier commit: its gpt_sovits_tpu_torch/) and on
    this tree's, each in a process of its own that builds its tree's
    kernels, in turns: parent, this, this, parent. Returns each run and the
    mean of each tree's two."""
    here = Path(__file__).resolve()
    code = (f"import importlib.util, json\n"
            f"spec = importlib.util.spec_from_file_location('smoke_times', {str(here)!r})\n"
            "c = importlib.util.module_from_spec(spec)\nspec.loader.exec_module(c)\n"
            "c.resolve_device('cuda')\n"
            f"print(json.dumps(c.kernel_times({seed})))\n")
    trees = {"parent": Path(parent).resolve(), "this": here.parent}
    runs = []
    for name in ("parent", "this", "this", "parent"):
        res = subprocess.run([sys.executable, "-c", code], cwd=trees[name], capture_output=True, text=True,
                             timeout=900)
        assert res.returncode == 0, f"kernel_times in {trees[name]}: {res.stderr[-3000:]}"
        runs.append({"tree": name, "times": json.loads(res.stdout.strip().splitlines()[-1])})
    mean = {}
    for name in trees:
        mine = [r["times"] for r in runs if r["tree"] == name]
        mean[name] = {key: {f: (None if any(t[key].get(f) is None for t in mine)
                                else sum(t[key][f] for t in mine) / len(mine))
                            for f in ("ms", "body_ms", "helper_ms", "wall_ms", "queued_ms")} for key in mine[0]}
    return {"parent_dir": str(trees["parent"]), "runs": runs, "mean": mean}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="also time K1-K6 on the kernels of an earlier tree unpacked here, in turns with this "
                         "tree's (compare_trees)")
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
            table[(quant, b)] = kernel_phase(s1_state, quant, b, args.seed)
            emit({"phase": "kernels", "kernel": "fused_decode_step", "mode": f"{quant}/{quant}", "B": b,
                  **table[(quant, b)]})
    emit({"phase": "widths", "B": list(range(2, ds.MAX_ROWS)), **width_phase(s1_state, args.seed)})
    del s1_state
    torch.cuda.empty_cache()

    bert, tok = build_bert(args.seed)
    emit({"phase": "bert", **bert_phase(bert, tok, args.seed)})
    pipe = build_pipeline(args.seed, bert, tok)
    del bert
    launches = path_phase(pipe, args.seed)  # counted from 0 just before the path's requests
    check_s1_launches(launches, launches["s1_steps"])
    agree = teacher_phase(pipe)
    emit({"phase": "teacher", "greedy_agreement": agree})
    assert agree >= 0.9, agree
    emit({"phase": "path", "launches": launches, "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9})
    with tempfile.TemporaryDirectory(prefix="gsv_smoke_") as tmp:
        launches_zh = path_zh_phase(pipe, args.seed, tmp)  # counted from 0 just before the zh requests
    check_s1_launches(launches_zh, launches_zh["s1_steps"])
    emit({"phase": "path_zh", "launches": launches_zh, "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "stream_v2", **stream_v2_phase(pipe, args.seed)})
    serve_rec, svc = serve_v2_phase(pipe, args.seed)
    try:
        emit({"phase": "serve_v2", **serve_rec})
        with tempfile.TemporaryDirectory(prefix="gsv_smoke_") as tmp:
            emit({"phase": "http", **http_phase(pipe, svc, args.seed, tmp)})
    finally:
        svc.close()

    del pipe, svc
    torch.cuda.empty_cache()

    # v4: the int8 DiT kernels at v4 shapes, then the full-width v4 path
    v4_rows = {}
    for b in (1, 4):
        for name, r in v4_kernel_phase(b, args.seed).items():
            emit({"phase": "kernels", "kernel": name, "B": b, **r})
            v4_rows[(name, b)] = r
    pipe4 = build_v4_pipeline(args.seed)
    reset_all_launch_counts()
    with counted_steps() as steps4:
        reqs = path_v4_phase(pipe4, args.seed)
    launches4 = all_launch_counts()  # counted from 0 just before the v4 requests
    n_cfm = sum(len(r["cfm_batch"]) for r in reqs)
    for name, per_call in V4_PER_CFM_CALL.items():
        assert launches4[name] == per_call * n_cfm, (name, launches4[name], per_call, n_cfm)
    launches4.update(check_s1_launches(launches4, steps4.n))
    emit({"phase": "path_v4", "launches": launches4, "cfm_calls": n_cfm,
          "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "cfm_teacher", **cfm_teacher_phase(pipe4, args.seed)})
    with tempfile.TemporaryDirectory(prefix="gsv_smoke_") as tmp:
        emit({"phase": "http_v4", **http_v4_phase(pipe4, args.seed, tmp)})
    del pipe4
    torch.cuda.empty_cache()

    # v3: K6 at BigVGAN's stage shapes and K4, then the full-width v3 path
    v3_rows = v3_kernel_phase(args.seed)
    pipe3 = build_v3_pipeline(args.seed)
    reset_all_launch_counts()
    with counted_steps() as steps3:
        calls = path_v3_phase(pipe3, args.seed)
    launches3 = all_launch_counts()  # counted from 0 just before the v3 requests
    for name, per_call in V3_PER_CFM_CALL.items():
        assert launches3[name] == per_call * calls["cfm"], (name, launches3[name], per_call, calls)
    assert launches3["snake_aa"] == SNAKE_PER_CALL * calls["vocoder"], (launches3["snake_aa"], calls)
    launches3.update(check_s1_launches(launches3, steps3.n))
    emit({"phase": "path_v3", "launches": launches3, "cfm_calls": calls["cfm"], "vocoder_calls": calls["vocoder"],
          "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "v3_profile", **v3_layer_profiles(pipe3, args.seed)})
    sn = snake_in_call(pipe3, args.seed)
    emit({"phase": "snake_in_call", **sn})
    long = cfm_long_phase(pipe3, args.seed)  # resets and reads the counts around its one kernel run
    emit({"phase": "cfm_long", **long})
    del pipe3
    torch.cuda.empty_cache()
    emit({"phase": "gemm_tiles", **gemm_tile_phase(args.seed)})
    if args.parent is not None:
        emit({"phase": "compare_trees", **compare_trees(args.parent, args.seed)})

    r = table[("int8", 1)]
    name = "fused_decode_step"
    kernels = [{
        "name": name, "route": "cuda", "source": KERNEL_SRC, "replaces": REPLACES,
        "launches": launches[name], "launches_zh": launches_zh[name], "launches_v4": launches4[name],
        "launches_v3": launches3[name], "launches_serve": serve_rec["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"], "timer": r["timer"],
        "config": "int8 weights + int8 KV, B=1, live 745 of 1024, one launch a 24-layer step; launches over the "
                  "v2 (launches), zh, v4 and v3 paths, and over serve_v2's waves (the 8-slot pool, one launch a pool "
                  "step)",
    }]
    helpers = {"qdense_int8": "row_quant", "qkv_rope_int8": "row_quant", "flash_attn_int8": "v_quant"}
    for name in ("qdense_int8", "qkv_rope_int8", "flash_attn_int8"):
        r = v4_rows[(name, 4)]
        kernels.append({
            "name": name, "route": "cuda", "source": V4_SRC[name], "replaces": V4_REPLACES[name],
            "launches": launches4[name], "helper_launches": {helpers[name]: launches4[helpers[name]]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "body_ms": r["body_ms"], "helper_ms": r["helper_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timer": r["timer"],
            "config": r["config"] + "; v4 DiT widths, ms includes the wrapper's " + helpers[name] + " launch "
                      "(helper_ms); library_ms compares with body_ms",
        })
    r = v3_rows[("qdense_out_int8", 1)]
    kernels.append({
        "name": "qdense_out_int8", "route": "cuda", "source": V4_SRC["qdense_int8"], "replaces": K4_REPLACES,
        "launches": long["launches"]["qdense_out_int8"],
        "helper_launches": {"row_quant_heads": long["launches"]["row_quant_heads"]},
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "body_ms": r["body_ms"], "helper_ms": r["helper_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "timer": r["timer"],
        "config": r["config"] + "; launches from the cfm_long phase (T 2560, 4 steps)",
    })
    kernels.append({
        "name": "snake_aa", "route": "cuda", "source": SNAKE_SRC, "replaces": SNAKE_REPLACES,
        "launches": launches3["snake_aa"],
        "max_abs_err": max(v3_rows[("snake_aa", torch.bfloat16, c, t)]["held"]["max_abs_err"] for c, t in V3_STAGES),
        **{k: sn[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "timer")}, "library_ms": None,
        "config": "one BigVGAN call on a 2224-frame mel in bf16 (snake_in_call): ms the device time of its 109 "
                  "launches, plain_ms that of the twins in their place; max_abs_err over the bf16 stage shapes "
                  "(v3_kernels); no single PyTorch call computes this function",
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
