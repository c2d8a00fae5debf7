"""The S1 pool's step tail as a CUDA graph: `pool_graph_step_share` on
synthetic records (CPU), and on the card, at the v2ProPlus serving layout
(8 slots, segments of 25 steps), the graphed pool against the same pool
with its tail run eagerly, before and after a weight swap's rebuild, and
`bench_port.check_records` on a traced run of `v2pp.serve.c16`."""

from __future__ import annotations

import json
import types
from pathlib import Path

import numpy as np
import pytest

from bench_port import run as bench_run
from gpt_sovits_tpu_torch.utils.metrics import Snapshot

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11
T = 5_000_000_000  # ns


def _snapshot(segments: list, counts: list, names=("pool.segment", "pool.graph_steps")) -> Snapshot:
    """segments: (t0, t1, steps); counts: (t, value) of `pool.graph_steps`."""
    names = list(names)
    seg_id = names.index("pool.segment")
    cnt_id = names.index("pool.graph_steps") if "pool.graph_steps" in names else -2
    k = len(segments)
    attr = np.zeros((k, 4), np.int64)
    attr[:, 0] = [s for _, _, s in segments]
    spans = {"seq": np.arange(1, k + 1), "name": np.full(k, seg_id, np.int64),
             "t0": np.array([a for a, _, _ in segments], np.int64), "t1": np.array([b for _, b, _ in segments], np.int64),
             "thread": np.ones(k, np.int64), "parent": np.zeros(k, np.int64), "rid": np.full(k, -1, np.int64),
             "attr": attr}
    cs = {"seq": np.arange(1, len(counts) + 1), "name": np.full(len(counts), cnt_id, np.int64),
          "t": np.array([t for t, _ in counts], np.int64), "value": np.array([v for _, v in counts], np.int64)}
    return Snapshot(names, spans, cs, {"seq": np.zeros(0, np.int64)})


def _read(monkeypatch, snap):
    from bench_port import clock

    monkeypatch.setattr(clock, "recorded", lambda: snap)
    run = types.SimpleNamespace(t0=T / 1e9, t_end=T / 1e9 + 1.0)
    return bench_run.load_metric("pool_graph_step_share").read(run)


def test_graph_step_share_reads_the_segments_in_the_window(monkeypatch):
    """Counts stamped inside the window's segments over their steps; a
    segment that ended outside the window and its count are left out."""
    ms = 1_000_000
    segs = [(T - 5 * ms, T - ms, 25), (T + ms, T + 8 * ms, 25), (T + 10 * ms, T + 17 * ms, 25)]
    counts = [(T - 2 * ms, 25), (T + 7 * ms, 25), (T + 16 * ms, 24)]
    assert _read(monkeypatch, _snapshot(segs, counts)) == pytest.approx(100.0 * 49 / 50)
    assert _read(monkeypatch, _snapshot(segs, [(t, 25) for t, _ in counts])) == pytest.approx(100.0)
    assert _read(monkeypatch, _snapshot(segs, [(t, 0) for t, _ in counts])) == 0.0


def test_graph_step_share_is_silent_without_the_counter(monkeypatch):
    """A program without `pool.graph_steps` (the parent of the tail graph)
    gives None, not 0; so does a window without a segment."""
    ms = 1_000_000
    segs = [(T + ms, T + 8 * ms, 25)]
    assert _read(monkeypatch, _snapshot(segs, [], names=("pool.segment",))) is None
    assert _read(monkeypatch, _snapshot([(T - 5 * ms, T - ms, 25)], [(T - 2 * ms, 25)])) is None
    assert _read(monkeypatch, None) is None


# -- on the card ----------------------------------------------------------------

SAMPLING = [dict(top_k=1), dict(top_k=5, temperature=1.0), dict(top_k=15, temperature=0.7), dict(top_k=5, temperature=0.7)]


def _decode(cb, prompt: np.ndarray, table: list, seed: int) -> list:
    """16 requests (two waves through 8 slots) of the mix's sampling, each
    with its own seed, submitted at once and drained in segments of 25."""
    rids = [cb.submit(np.asarray(table[i % len(table)]["phones"], np.int64), None, prompt, seed=seed + i,
                      **SAMPLING[i % len(SAMPLING)]) for i in range(16)]
    got = cb.drain(n=25)
    return [got[r] for r in rids]


def _eager(svc, monkeypatch):
    """The service's pool as its rebuild makes it, with the tail run eagerly."""
    from gpt_sovits_tpu_torch.infer.continuous import ContinuousBatcher

    with monkeypatch.context() as mp:
        mp.setattr(ContinuousBatcher, "_graphable", lambda self: False)
        cb = svc._build_batcher()
        cb.warmup(svc.segment)
    assert cb.graph_captures == 0
    return cb


@pytest.mark.card
def test_graphed_pool_equals_eager_tail(card, monkeypatch):
    """At the serving layout, the pool whose tail is a graph replay gives
    the tokens of the same pool with the tail run eagerly, bit for bit, for
    greedy and top_k 5/15 rows; and again after a weight swap gives the
    service a new S1 (new parameter storage) and rebuilds its pool."""
    from bench_port import traffic
    from bench_port.families import vits
    from bench_port.weights import fill
    from gpt_sovits_tpu_torch.ops.decode_step import stack_weights_from_params
    from gpt_sovits_tpu_torch.serve.continuous_service import ContinuousTTSService

    cfg = bench_run.load_json(ROOT / "bench_port" / "configs" / "v2ProPlus.json")
    s = cfg["serving"]
    pipe = vits.build(cfg, SEED, card)
    svc = ContinuousTTSService(pipe, slots=s["slots"], segment=s["segment"], tx_max=s["tx_max"], tp_max=s["tp_max"],
                               max_new=s["max_new"])
    svc.close()  # the test steps the pools itself, from this thread
    table = traffic.load("sentences_en")["sentences"]
    prompt = np.asarray(pipe.ref.prompt_semantic, np.int64)
    results = []
    for swap in (False, True):
        if swap:
            with svc.paused_for_weight_swap():
                fill(pipe.s1, SEED + 1, "s1", cfg.get("weights"))
                pipe._s1_weights = stack_weights_from_params(pipe.s1.state_dict(), pipe.s1.cfg.num_layers,
                                                             quant=pipe.s1_weight_quant)
        graphed = svc.cb
        assert graphed.use_fused and graphed.graph_captures == 1
        got = _decode(graphed, prompt, table, 7000)
        want = _decode(_eager(svc, monkeypatch), prompt, table, 7000)
        assert graphed.graph_captures == 1
        assert sum(len(t) for t in got) > 16
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        results.append(got)
    assert any(not np.array_equal(a, b) for a, b in zip(*results)), "the swap left the tokens as they were"


@pytest.mark.card
def test_check_records_passes_on_the_serving_cell(card, monkeypatch):
    """A traced run of `v2pp.serve.c16`: K1's launch records equal its kernel
    events in every matched slice, the pool's accounting holds, and every
    tail of the pool's steps in the window was a graph replay, profiled
    slices included."""
    from bench_port import check_records

    monkeypatch.chdir(ROOT)
    lines = []
    monkeypatch.setattr("builtins.print", lambda *a, **kw: lines.append(" ".join(map(str, a))))
    # a 30 s window, as the command is run: in a 10 s one a single admission
    # pass cut by the window's edge moves the accounting by ~10%
    rc = check_records.main(["--workload", "v2pp.serve.c16", "--seed", str(SEED), "--seconds", "30"])
    out = json.loads(lines[-1])
    assert rc == 0, out["failed"]
    assert any(c["mapped"] for c in out["slices"]), out["slices"]
    assert out["metrics"]["pool_graph_step_share"] == 100.0
