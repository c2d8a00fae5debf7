"""The v3 configuration's pieces and the `v2pp.serial.b8` cell, on the CPU:
flops/bigvgan.py against multiply-accumulates counted on the reference's
BigVGAN and against the bytes of the port's K6 launches; the four new
readers at made-up timings that equal the bound and on synthetic records;
the new mixes as functions of the seed; and a whole (small) run of each new
cell, sound and with its timed path broken underneath: a sound run is
`correct`, a broken one is not, by the cell's own limits."""

from __future__ import annotations

import types
from collections import Counter

import numpy as np
import pytest
import torch

from bench_port import clock, traffic
from bench_port import run as bench_run
from bench_port.flops import bigvgan as fbig
from bench_port.flops.peaks import HBM_BYTES_S, compute_s
from bench_port.reference import bigvgan as rbig
from bench_port.tests import tiny
from bench_port.weights import fill
from gpt_sovits_tpu_torch.utils.metrics import Snapshot

SEED = 2**31 + 181
VOC = {**tiny.config("v3")["vocoder"], "upsample_initial_channel": 64}


def small_v3(cfg: dict) -> dict:
    cfg["vocoder"]["upsample_initial_channel"] = 64
    cfg["apbwe"].update(channels=32, layers=2)
    cfg["weights"]["gains"]["vocoder"]["conv_post.weight"] = 0.3
    return cfg


def test_bigvgan_macs_as_the_reference_runs_them():
    """Each part's multiply-accumulates (flops/bigvgan.py conv_macs) equal
    those the reference's convolution modules run, counted by hooks."""
    model = rbig.BigVGAN(VOC)
    fill(model, 1, "vocoder")
    part = {"conv_pre": "pre", "ups.0.0": "up0", "conv_post": "post"}
    counted = Counter()

    def hook(name):
        def count(m, args, out):
            if isinstance(m, torch.nn.ConvTranspose1d):
                counted[part.get(name, "inner")] += args[0].shape[0] * args[0].shape[2] * m.weight.numel()
            else:
                counted[part.get(name, "inner")] += out.shape[0] * out.shape[2] * m.weight.numel()
        return count

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))]
    frames, rows = 5, 2
    with torch.no_grad():
        model(torch.randn(rows, frames, 100))
    for h in handles:
        h.remove()
    want = {k: rows * v for k, v in fbig.conv_macs(VOC, frames).items()}
    assert dict(counted) == want
    assert fbig.call(VOC, frames, rows)["ops"] == {k: 2 * v for k, v in want.items()}


def test_k6_bytes_are_each_launchs_input_and_output(monkeypatch):
    """The port's BigVGAN launches K6 (on the CPU its twin) as k6_launches
    lists them, and each launch's bytes are its bf16 input and output and
    its f32 alpha and beta."""
    from gpt_sovits_tpu_torch.models import bigvgan as pbig

    model = pbig.BigVGAN(pbig.BigVGANConfig(**{k: v for k, v in VOC.items() if k != "in_channels"}))
    fill(model, 1, "vocoder")
    model = model.to(torch.bfloat16)
    seen, inner = [], pbig.snake_aa

    def spy(x, alpha, beta, **kw):
        y = inner(x, alpha, beta, **kw)
        seen.append(((x.shape[1], x.shape[2]), x.nbytes + y.nbytes + alpha.nbytes + beta.nbytes, x.shape[0]))
        return y

    monkeypatch.setattr(pbig, "snake_aa", spy)
    frames, rows = 3, 2
    with torch.no_grad():
        model(torch.randn(rows, frames, 100, dtype=torch.bfloat16))
    assert [s for s, _, _ in seen] == fbig.k6_launches(VOC, frames) and len(seen) == 6 * 18 + 1
    assert [b for _, b, _ in seen] == [fbig.k6_bytes(c, t, rows) for c, t in fbig.k6_launches(VOC, frames)]
    assert fbig.call(VOC, frames, rows)["k6_bytes"] == sum(b for _, b, _ in seen)


def _snapshot(spans: list, launches: list = ()) -> Snapshot:
    """spans: (seq, name, t0_ns, t1_ns, parent, attrs); launches: (kernel, t_ns)."""
    names = sorted({s[1] for s in spans} | {k for k, _ in launches})
    ids = {n: i for i, n in enumerate(names)}
    attr = np.zeros((len(spans), 4), np.int64)
    for i, s in enumerate(spans):
        attr[i, : len(s[5])] = s[5]
    sp = {"seq": np.array([s[0] for s in spans], np.int64), "name": np.array([ids[s[1]] for s in spans], np.int64),
          "t0": np.array([s[2] for s in spans], np.int64), "t1": np.array([s[3] for s in spans], np.int64),
          "thread": np.ones(len(spans), np.int64), "parent": np.array([s[4] for s in spans], np.int64),
          "rid": np.full(len(spans), -1, np.int64), "attr": attr}
    la = {"seq": np.arange(1, len(launches) + 1), "name": np.array([ids[k] for k, _ in launches], np.int64),
          "t": np.array([t for _, t in launches], np.int64)}
    return Snapshot(names, sp, {"seq": np.zeros(0, np.int64)}, la)


def test_bigvgan_and_k6_rooflines_reach_100_at_the_bound(monkeypatch):
    """A traced request of two BigVGAN calls whose K6 launches and the
    kernels between them take exactly the least time: both shares read
    100%; idle time between the kernels lowers neither (the busy time is
    the denominator), a second K6 event time doubles K6's."""
    cfg = {"vocoder": VOC, "precision": {"vocoder": "bf16"}}
    t, calls, spans, launches, kernels = 10**9, [(7, 1), (4, 1)], [], [], []
    offset, cursor = 500.0, 0.0  # the profiler's clock minus the host's (us); the device's clock
    least = 0.0
    for i, (frames, rows) in enumerate(calls):
        work = fbig.call(VOC, frames, rows)
        conv_us = compute_s(work["ops"]["inner"], "bf16") * 1e6
        k6 = fbig.k6_launches(VOC, frames)
        each = [fbig.k6_bytes(c, n, rows) / HBM_BYTES_S * 1e6 for c, n in k6]
        t0 = t + 10**8 * i
        spans.append((i + 1, "vocoder.call", t0, t0 + 10**6, 0, (frames, rows)))
        cursor = max(cursor, t0 / 1e3 + offset + 50.0)
        kernels.append(("conv_pre", cursor - 40.0, cursor - 10.0))  # before the first K6: left out
        for j, us in enumerate(each):
            launch = t0 + 1000 * (j + 1)
            launches.append(("snake_aa_kernel", launch))
            cursor = max(cursor, launch / 1e3 + offset + 2.0)
            kernels.append(("void snake_aa_kernel<true>(Args)", cursor, cursor + us))
            cursor += us
            if j < len(each) - 1:
                gap = conv_us / (len(each) - 1)
                kernels.append(("sm90_xmma_fprop_bf16", cursor + 5.0, cursor + 5.0 + gap))
                cursor += gap + 10.0
        least += work["k6_bytes"] / HBM_BYTES_S + compute_s(work["ops"]["inner"], "bf16")
    snap = _snapshot(spans, launches)
    monkeypatch.setattr(clock, "recorded", lambda: snap)
    k6_s = sum(e - s for n, s, e in kernels if "snake" in n) / 1e6
    reading = types.SimpleNamespace(kernels=kernels, t0=t / 1e9 - 1, t1=t / 1e9 + 1, matched=True,
                                    kernel_s=lambda pattern: k6_s)
    run = types.SimpleNamespace(cfg=cfg, reading=reading)
    assert bench_run.load_metric("bigvgan_roofline").read(run) == pytest.approx(100.0)
    assert bench_run.load_metric("snake_aa_roofline").read(run) == pytest.approx(100.0)
    reading.kernel_s = lambda pattern: 2 * k6_s
    assert bench_run.load_metric("snake_aa_roofline").read(run) == pytest.approx(50.0)
    monkeypatch.setattr(clock, "recorded", lambda: _snapshot([], launches))
    assert bench_run.load_metric("bigvgan_roofline").read(run) is None  # a program without the span
    assert bench_run.load_metric("snake_aa_roofline").read(run) is None


def test_apbwe_readers_on_synthetic_records(monkeypatch):
    """Two segments in the window (resample 1 + fetch 2 of 10 ms, then 3 +
    1 of 20 ms), a third in a profiled request, left out: 7 of 30 ms."""
    ms = 10**6
    spans = [(1, "apbwe.segment", 100 * ms, 110 * ms, 0, ()), (2, "apbwe.resample", 100 * ms, 101 * ms, 1, ()),
             (3, "apbwe.launch", 101 * ms, 108 * ms, 1, ()), (4, "apbwe.fetch", 108 * ms, 110 * ms, 1, ()),
             (5, "apbwe.segment", 200 * ms, 220 * ms, 0, ()), (6, "apbwe.resample", 200 * ms, 203 * ms, 5, ()),
             (7, "apbwe.fetch", 219 * ms, 220 * ms, 5, ()),
             (8, "apbwe.segment", 300 * ms, 340 * ms, 0, ()), (9, "apbwe.fetch", 300 * ms, 340 * ms, 8, ())]
    monkeypatch.setattr(clock, "recorded", lambda: _snapshot(spans))
    run = types.SimpleNamespace(t0=0.05, t_end=1.0, records=[{"sent": 0.29, "done": 0.35, "profiled": True}],
                                done=[{"timing": {"apbwe": 0.5}, "audio": np.zeros(96000), "sr": 48000},
                                      {"timing": {"apbwe": 0.3}, "audio": np.zeros(48000), "sr": 48000},
                                      {"timing": {"apbwe": 9.0}, "audio": np.zeros(48000), "sr": 48000,
                                       "profiled": True}])
    assert bench_run.load_metric("apbwe_host_share").read(run) == pytest.approx(100.0 * 7 / 30)
    assert bench_run.load_metric("apbwe_phase_s_per_audio_s").read(run) == pytest.approx(0.8 / 3.0)
    monkeypatch.setattr(clock, "recorded", lambda: _snapshot([]))
    assert bench_run.load_metric("apbwe_host_share").read(run) is None


@pytest.mark.parametrize("mix", ["para_en_sr", "serial_b8_en"])
def test_new_mixes_follow_the_seed(mix):
    m = traffic.load(mix)

    def draws(seed: int, n: int) -> list:
        seq = traffic.Requests(m, seed)
        return [seq.next() for _ in range(n)]

    big = 2**31 + 4321
    assert draws(big, 10) == draws(big, 10) != draws(big + 1, 10)
    assert sorted(len(r["sentences"]) for r in draws(5, sum(m["shapes"]["counts"]))) == [4, 5, 6, 7, 8]


def small(name: str) -> bench_run.Cell:
    c = tiny.cell(name, shapes=[{"segments": 2, "max_sec": 2}])
    c.mix["sampling"] = [{"top_k": 1}, {"top_k": 5, "temperature": 1.0}]
    c.spec = {**c.spec, "sample": {"greedy": 1, "any": 1}}
    if c.cfg["family"] == "cfm_sr":
        small_v3(c.cfg)
    return c


def measure(name: str, seconds: float) -> tuple:
    torch.set_num_threads(1)  # light beside the other files' whole runs on their workers
    return bench_run.measure(small(name), SEED, seconds, False, device="cpu")


def scaled(fn, factor: float, index=None):
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        return (out[0] * factor,) + tuple(out[1:]) if index == 0 else out * factor
    return wrapper


def test_v3_sound_run_is_correct_and_reads_the_apbwe_spans():
    result, run = measure("v3.batch.sr", 6.0)
    assert result["correct"], result["checks"]
    assert result["checked"]["greedy_tokens"] > 0 and run.done[0]["sr"] == 48000
    assert set(result["checks"]) == {"s1_gap", "mel_err", "wave_ratio", "sr_err"}
    for m in ("apbwe_phase_s_per_audio_s", "apbwe_host_share"):
        value = bench_run.load_metric(m).read(run)
        assert value is not None and value > 0, m
    for m in ("bigvgan_roofline", "snake_aa_roofline"):
        assert bench_run.load_metric(m).read(run) is None  # a CPU run profiles nothing


@pytest.mark.parametrize("where,check", [("super_resolve", "sr_err"), ("bigvgan", "wave_ratio")])
def test_v3_broken_stage_is_not_correct(monkeypatch, where, check):
    """AP-BWE's output scaled by 0.99 where it is produced, or BigVGAN's by
    0.25 (at these widths the bf16 yardstick reads ~8%, so 0.9 reads a
    ratio of only ~1.2): the stage's own number fails its limit."""
    from gpt_sovits_tpu_torch.infer import pipeline
    from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN

    if where == "super_resolve":
        monkeypatch.setattr(pipeline, "super_resolve", scaled(pipeline.super_resolve, 0.99, index=0))
    else:
        monkeypatch.setattr(BigVGAN, "forward", scaled(BigVGAN.forward, 0.25))
    result, _ = measure("v3.batch.sr", 6.0)
    assert not result["correct"] and result["checks"][check]["value"] > result["checks"][check]["limit"]


def test_serial_sound_run_is_correct():
    result, run = measure("v2pp.serial.b8", 2.0)
    assert result["correct"], result["checks"]
    assert result["checked"]["greedy_tokens"] > 0
    r = run.done[0]
    assert [list(p) for p in r["phones"]] == [run.sentences["sentences"][i]["phones"] for i in r["req"]["sentences"]]
    for m in ("s1_phase_s_per_audio_s", "mfu"):
        assert bench_run.load_metric(m).read(run) > 0


def test_serial_token_altered_is_not_correct(monkeypatch):
    from gpt_sovits_tpu_torch.models import t2s

    calls = [0]
    inner = t2s.sample_token

    def altered(*args, **kw):
        tok = inner(*args, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0 and kw["top_k"] == 1:
            tok = (tok + 1) % 1024
        return tok

    monkeypatch.setattr(t2s, "sample_token", altered)
    result, _ = measure("v2pp.serial.b8", 2.0)
    assert not result["correct"] and result["checks"]["s1_gap"]["value"] > result["checks"]["s1_gap"]["limit"]
