"""The port's recorder of spans and counters (gpt_sovits_tpu_torch/utils/
metrics.py `Recorder`, `PhaseTimer`) on the CPU: spans nest with their
parents, threads and request ids; the rings stay bounded; fine records are
taken only while tracing is on (`enable()`, or a torch.profiler session on
any thread); `PhaseTimer` keeps its names, values and report line; and the
instrumented `generate` and `cfm_inference` record their steps."""

import re
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from gpt_sovits_tpu_torch.models.dit import DiT, DiTConfig
from gpt_sovits_tpu_torch.models.t2s import STOP_CHECK_EVERY, T2SDecoder, generate
from gpt_sovits_tpu_torch.models.v3 import cfm_inference
from gpt_sovits_tpu_torch.utils import metrics
from gpt_sovits_tpu_torch.utils.config import S1Config

torch.set_num_threads(1)


def _since(t0: int, spans: dict) -> dict:
    keep = spans["t0"] >= t0
    return {c: v[keep] for c, v in spans.items()}


def test_spans_nest_with_parents_threads_and_request_ids():
    rec = metrics.Recorder(spans=64)
    outer, inner, other = rec.intern("outer"), rec.intern("inner"), rec.intern("other")
    a = rec.begin(outer, 7)
    b = rec.begin(inner, 7)
    assert rec.end(b, 3, 4) > 0
    c = rec.record(other, 10, 20, 9, 5)  # closed, with the caller's times, inside `outer`
    rec.end(a)
    seen = {}

    def worker():
        seen["thread"] = threading.get_native_id()
        with rec.span("outer", 8) as s:
            seen["seq"] = s

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    sp = rec.snapshot().spans
    by_seq = {int(s): k for k, s in enumerate(sp["seq"])}
    assert sp["parent"][by_seq[a]] == 0 and sp["parent"][by_seq[b]] == a and sp["parent"][by_seq[c]] == a
    assert sp["rid"][by_seq[a]] == sp["rid"][by_seq[b]] == 7 and sp["rid"][by_seq[c]] == 9
    assert list(sp["attr"][by_seq[b]]) == [3, 4, 0, 0] and list(sp["attr"][by_seq[c]]) == [5, 0, 0, 0]
    assert (sp["t0"][by_seq[c]], sp["t1"][by_seq[c]]) == (10, 20)
    assert sp["t0"][by_seq[a]] <= sp["t0"][by_seq[b]] <= sp["t1"][by_seq[b]] <= sp["t1"][by_seq[a]]
    # the other thread's span has no parent there, whatever this thread had open
    k = by_seq[seen["seq"]]
    assert sp["parent"][k] == 0 and sp["thread"][k] == seen["thread"] != threading.get_native_id()
    assert sp["thread"][by_seq[a]] == threading.get_native_id() and sp["rid"][k] == 8


def test_an_unclosed_inner_span_closes_with_its_parent():
    rec = metrics.Recorder(spans=16)
    name = rec.intern("x")
    a = rec.begin(name)
    rec.begin(name)  # left open, as an exception would leave it
    rec.end(a)
    c = rec.begin(name)
    rec.end(c)
    sp = rec.snapshot().spans
    assert sp["parent"][list(sp["seq"]).index(c)] == 0


def test_rings_stay_bounded():
    rec = metrics.Recorder(spans=8, counts=4, launches=4)
    rec.enable()
    name = rec.intern("s")
    shapes = {k: v.shape for k, v in vars(rec._spans).items() if isinstance(v, np.ndarray)}
    first = rec.begin(name)
    for i in range(40):
        rec.end(rec.begin(name), i)
        rec.count(name, i)
        rec.launch(name)
    assert rec.end(first) == 0  # overwritten while open: nothing to close
    snap = rec.snapshot()
    assert {k: v.shape for k, v in vars(rec._spans).items() if isinstance(v, np.ndarray)} == shapes
    assert len(snap.spans["seq"]) == 8 and len(snap.counts["seq"]) == 4
    assert len(snap.launches["seq"]) == 4
    assert list(snap.spans["seq"]) == list(range(34, 42))  # the newest, in order
    assert list(snap.counts["value"]) == [36, 37, 38, 39] and list(snap.launches["seq"]) == [37, 38, 39, 40]


def test_many_threads_lose_no_row():
    rec = metrics.Recorder(spans=1 << 14)
    name = rec.intern("w")
    threads, per = 24, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(k):
            for _ in range(per):
                outer = rec.begin(name, k)
                rec.end(rec.begin(name, k))
                rec.end(outer)

        ths = [threading.Thread(target=worker, args=(k,)) for k in range(threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    sp = rec.snapshot().spans
    assert len(sp["seq"]) == len(set(sp["seq"].tolist())) == 2 * threads * per
    assert (sp["t1"] >= sp["t0"]).all()
    seq_rid = dict(zip(sp["seq"].tolist(), sp["rid"].tolist()))
    for rid, parent in zip(sp["rid"].tolist(), sp["parent"].tolist()):
        assert parent == 0 or seq_rid[parent] == rid  # a parent is always of the same thread


def test_no_fine_record_while_tracing_is_off():
    rec = metrics.Recorder(launches=16)
    k = rec.intern("step_kernel")
    assert not rec.fine()
    rec.launch(k)
    assert len(rec.snapshot().launches["seq"]) == 0
    t0 = time.perf_counter_ns()
    rec.enable()
    rec.launch(k)
    rec.disable()
    rec.launch(k)
    la = rec.snapshot().launches
    assert len(la["seq"]) == 1 and t0 <= la["t"][0] <= time.perf_counter_ns()
    assert rec.snapshot().launch_names() == ["step_kernel"]


def test_a_profiler_on_another_thread_turns_fine_records_on():
    rec = metrics.Recorder(launches=16)
    k = rec.intern("k")
    started, stop = threading.Event(), threading.Event()

    def profiled():
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            started.set()
            stop.wait(timeout=60)

    th = threading.Thread(target=profiled)
    th.start()
    try:
        assert started.wait(timeout=60)
        assert rec.fine()
        rec.launch(k)
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive() and not rec.fine()
    rec.launch(k)
    assert len(rec.snapshot().launches["seq"]) == 1


def test_phase_timer_keeps_its_names_values_and_report():
    t_from = time.perf_counter_ns()
    timer = metrics.PhaseTimer(rid=41)
    with timer.phase("s1"):
        time.sleep(0.002)
    with timer.phase("cfm"):
        pass
    with timer.phase("s1"):
        time.sleep(0.001)
    with pytest.raises(RuntimeError):
        with timer.phase("vocoder"):
            raise RuntimeError("left out of the sums")
    assert list(timer.phases) == ["s1", "cfm"] and timer.phases["s1"] >= 0.003
    snap = metrics.recorder().snapshot()
    s1 = _since(t_from, snap.spans_named("phase.s1"))
    assert list(s1["rid"]) == [41, 41]
    assert timer.phases["s1"] == pytest.approx(sum((s1["t1"] - s1["t0"]).tolist()) / 1e9, abs=1e-12)
    assert len(_since(t_from, snap.spans_named("phase.vocoder"))["seq"]) == 1
    report = timer.report()
    assert re.fullmatch(r"s1:\d+\.\d{3}s cfm:\d+\.\d{3}s total:\d+\.\d{3}s", report)
    assert report.endswith(f"total:{sum(timer.phases.values()):.3f}s")


S1 = dict(vocab_size=41, phoneme_vocab_size=100, embedding_dim=32, hidden_dim=32, num_heads=2, ffn_dim=64,
          num_layers=1, eos_id=40, bert_dim=8, max_len=512, semantic_frame_rate=25)


def _generate(model, steps: int):
    tx, tp = 6, 5
    g = torch.Generator().manual_seed(0)
    return generate(model, torch.randint(1, 100, (1, tx), generator=g), torch.tensor([tx]), torch.zeros(1, tx, 8),
                    torch.randint(0, 40, (1, tp), generator=g), torch.tensor([tp]), g, max_new_tokens=steps,
                    early_stop_num=steps, top_k=1)


def test_generate_records_its_steps_only_while_tracing():
    torch.manual_seed(0)
    model = T2SDecoder(S1Config(**S1)).eval()
    rec = metrics.recorder()
    steps = 2 * STOP_CHECK_EVERY + 3
    with torch.no_grad():
        t_from = time.perf_counter_ns()
        out = _generate(model, steps)
        snap = rec.snapshot()
        assert len(_since(t_from, snap.spans_named("s1.step"))["seq"]) == 0
        reads = len(_since(t_from, snap.spans_named("s1.done_read"))["seq"])
        assert reads == (int(out.steps) - 1) // STOP_CHECK_EVERY
        rec.enable()
        try:
            t_from = time.perf_counter_ns()
            out = _generate(model, steps)
        finally:
            rec.disable()
    snap = rec.snapshot()
    fine = _since(t_from, snap.spans_named("s1.step"))
    assert list(fine["attr"][:, 0]) == list(range(1, int(out.steps)))


@pytest.mark.parametrize("n_steps", [1, 4])
def test_cfm_inference_records_each_euler_step(n_steps):
    torch.manual_seed(0)
    cfg = DiTConfig(dim=64, depth=1, heads=2, dim_head=32, mel_dim=8, text_dim=16, conv_layers=1)
    dit = DiT(cfg).eval()
    b, t = 2, 24
    t_from = time.perf_counter_ns()
    with torch.no_grad():
        cfm_inference(dit, torch.randn(b, t, 16), torch.tensor([t, 20]), torch.randn(b, 6, 8),
                      noise=torch.randn(b, t, 8), n_steps=n_steps)
    snap = metrics.recorder().snapshot()
    calls = _since(t_from, snap.spans_named("cfm.call"))
    steps = _since(t_from, snap.spans_named("cfm.step"))
    assert len(calls["seq"]) == 1 and list(calls["attr"][0, :3]) == [b, t, n_steps]
    assert list(steps["attr"][:, 0]) == list(range(n_steps)) and (steps["parent"] == calls["seq"][0]).all()
    assert calls["t0"][0] <= steps["t0"].min() and steps["t1"].max() <= calls["t1"][0]


def test_vocoder_call_and_apbwe_segments_are_recorded():
    """`TTSPipeline._vocoder` records a `vocoder.call` span (the mel's
    frames and rows); `_apbwe` an `apbwe.segment` span a segment, inside it
    `super_resolve`'s `apbwe.resample` and `apbwe.launch` and the pipeline's
    `apbwe.fetch`, in that order, and `apbwe.samples_out` counts each
    segment's output samples. The pipeline is built around the two models
    alone (no S1, S2 or reference)."""
    from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline
    from gpt_sovits_tpu_torch.models.apbwe import APBWEConfig, APNetBWE
    from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig

    torch.manual_seed(0)
    pipe = object.__new__(TTSPipeline)
    pipe._voc = BigVGAN(BigVGANConfig(upsample_initial_channel=64), use_kernel=False).eval()
    pipe._voc_dtype = torch.float32
    pipe.v3 = types.SimpleNamespace(sr_model=APNetBWE(APBWEConfig(channels=16, layers=1)).eval(), out_sr=24000)
    t_from = time.perf_counter_ns()
    with torch.no_grad():
        wav = pipe._vocoder(torch.randn(2, 5, 100))
    out = pipe._apbwe([np.zeros(2400, np.float32), np.full(1200, 0.1, np.float32)], None, metrics.PhaseTimer())
    snap = metrics.recorder().snapshot()
    voc = _since(t_from, snap.spans_named("vocoder.call"))
    assert wav.shape == (2, 5 * 256, 1) and list(voc["attr"][0]) == [5, 2, 0, 0] and len(voc["seq"]) == 1
    segs = _since(t_from, snap.spans_named("apbwe.segment"))
    assert len(segs["seq"]) == 2
    for k, seq in enumerate(segs["seq"]):
        kids = [_since(t_from, snap.spans_named(n)) for n in ("apbwe.resample", "apbwe.launch", "apbwe.fetch")]
        rows = [np.flatnonzero(c["parent"] == seq) for c in kids]
        assert [len(r) for r in rows] == [1, 1, 1]
        starts = [int(c["t0"][r[0]]) for c, r in zip(kids, rows)]
        assert segs["t0"][k] <= starts[0] <= starts[1] <= starts[2] <= segs["t1"][k]
    samples = snap.counts_named("apbwe.samples_out")
    assert list(samples["value"][samples["t"] >= t_from]) == [len(w) for w in out] == [4800, 2400]
