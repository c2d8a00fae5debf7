"""The program's records as the benchmark reads them (bench_port/clock.py
and the readers built on it): the clock mapping on synthetic launch records
and kernel events (a known offset is recovered, an unmatched or misordered
slice is refused), the idle shares inside spans, the idle split by open
span, bench_port/check_records.py's checks, and each new reader on a small
CPU run of each cell (the readers of the slice return None there: a CPU run
profiles nothing)."""

from __future__ import annotations

import importlib
import types

import numpy as np
import pytest
import torch

from bench_port import check_records, clock
from bench_port import run as bench_run
from bench_port import traffic
from bench_port.tests import tiny
from gpt_sovits_tpu_torch.utils.metrics import Snapshot

OFFSET_US = 123456.5  # the profiler's clock minus the host's, in us
SEED = 2**31 + 7


def _snapshot(launches: list, spans: list = ()) -> Snapshot:
    """launches: (kernel, t_ns); spans: (name, t0_ns, t1_ns, thread)."""
    names = sorted({k for k, _ in launches} | {s[0] for s in spans})
    ids = {n: i for i, n in enumerate(names)}
    la = {"seq": np.arange(1, len(launches) + 1), "name": np.array([ids[k] for k, _ in launches], np.int64),
          "t": np.array([t for _, t in launches], np.int64)}
    sp = {"seq": np.arange(1, len(spans) + 1), "name": np.array([ids[s[0]] for s in spans], np.int64),
          "t0": np.array([s[1] for s in spans], np.int64), "t1": np.array([s[2] for s in spans], np.int64),
          "thread": np.array([s[3] for s in spans], np.int64), "parent": np.zeros(len(spans), np.int64),
          "rid": np.full(len(spans), -1, np.int64), "attr": np.zeros((len(spans), 4), np.int64)}
    empty = {"seq": np.zeros(0, np.int64)}
    return Snapshot(names, sp, empty, la)


def _reading(kernels: list, t0_ns: int, t1_ns: int):
    return types.SimpleNamespace(kernels=kernels, t0=t0_ns / 1e9, t1=t1_ns / 1e9, matched=True)


def _events(launches: list, lag_us) -> list:
    """Device events of the launches: each starts `lag` after its launch
    (on the profiler's clock) and runs 5 us; the names as the profiler
    gives them."""
    full = {"step_kernel": "void (anonymous namespace)::step::step_kernel<true, true>(StepArgs)",
            "row_quant_kernel": "void (anonymous namespace)::row_quant_kernel<false>(bf16 const*)"}
    out = []
    for (k, t), lag in zip(launches, lag_us):
        s = t / 1e3 + OFFSET_US + lag
        out.append((full[k], s, s + 5.0))
    return out


def test_a_known_offset_is_recovered():
    t = 10_000_000_000
    # 10 us apart: one stream starts its kernels in launch order
    launches = [("step_kernel", t + 10_000 * i) if i % 3 else ("row_quant_kernel", t + 10_000 * i) for i in range(30)]
    lags = 2.0 + np.arange(30) % 7  # the smallest lag 2 us
    reading = _reading(_events(launches, lags) + [("elementwise_kernel", 0.0, 1.0)], t - 10, t + 10**6)
    cmap = clock.map_slice(reading, _snapshot(launches))
    assert cmap is not None and set(cmap.pairs) == {"step_kernel", "row_quant_kernel"}
    assert cmap.offset_us == pytest.approx(OFFSET_US + 2.0)
    assert cmap.lags_us().min() == pytest.approx(0.0) and np.median(cmap.lags_us()) == pytest.approx(3.0)
    assert np.median(cmap.single_lags_us()) == pytest.approx(3.0) and cmap.inversions == 0
    # no kernel starts before its mapped launch record
    for ts, starts, _ in cmap.pairs.values():
        assert (starts >= cmap.to_device(ts) - 1e-6).all()


@pytest.mark.parametrize("bump_us", [0.0, 3000.0])
def test_a_drifting_profiler_clock_is_followed(bump_us):
    """The profiler's clock runs 1.5% slow against the host's, and (second
    case) wanders 3 ms off that rate and back over the slice: the local
    offsets keep each true lag (2-8 us) within 50 us (the smallest lag of
    the neighbours drifts meanwhile), where one offset for the slice reads
    milliseconds."""
    t = 20_000_000_000
    n = 2000
    launches = [("row_quant_kernel", t + 150_000 * i) for i in range(n)]  # one launch every 150 us
    lags = 2.0 + np.arange(n) % 7
    drift = -0.015 * 150 * np.arange(n) + bump_us * np.sin(np.pi * np.arange(n) / n)
    events = [(k, s + dr, e + dr) for (k, s, e), dr in zip(_events(launches, lags), drift)]
    cmap = clock.map_slice(_reading(events, t - 1, t + 10**9), _snapshot(launches))
    true = cmap.lags_us() - (lags - 2.0)
    assert cmap.lags_us().min() >= -1e-6 and np.abs(true).max() < (1e-6 if bump_us == 0 else 50.0)
    ts, starts, _ = cmap.pairs["row_quant_kernel"]
    assert np.max(starts - (ts / 1e3 + cmap.offset_us)) > 2000.0  # what one offset would read


def test_records_outside_the_slice_are_left_out_and_unmatched_counts_refused():
    t = 5_000_000_000
    launches = [("step_kernel", t + 1000 * i) for i in range(10)]
    events = _events(launches, [3.0] * 10)
    snap = _snapshot(launches + [("step_kernel", t + 10**7)])  # launched after the slice
    assert clock.map_slice(_reading(events, t - 1, t + 10**6), snap) is not None
    assert clock.map_slice(_reading(events[:-1], t - 1, t + 10**6), snap) is None  # an event short
    only_rq = _snapshot([("row_quant_kernel", t + 1000 * i) for i in range(10)])
    assert clock.map_slice(_reading(events, t - 1, t + 10**6), only_rq) is None  # another kernel
    assert clock.map_slice(_reading(events, t - 1, t + 10**6), None) is None


def test_a_pairing_out_of_launch_order_is_refused():
    """One stream runs kernels in launch order: where a kernel's events
    start before those of kernels launched earlier, the pairing is wrong."""
    t = 7_000_000_000
    launches = [("step_kernel", t + 20_000 * i) if i % 2 else ("row_quant_kernel", t + 20_000 * i) for i in range(8)]
    in_order = _events(launches, [2.0] * 8)
    assert clock.map_slice(_reading(in_order, t - 1, t + 10**6), _snapshot(launches)).inversions == 0
    swapped = _events(launches, [30.0 if k == "row_quant_kernel" else 2.0 for k, _ in launches])
    swapped = [(n, s - 25.0, e - 25.0) if "step" in n else (n, s, e) for n, s, e in swapped]
    assert clock.map_slice(_reading(swapped, t - 1, t + 10**6), _snapshot(launches)) is None


def test_idle_inside_spans_and_by_open_span(monkeypatch):
    t = 1_000_000_000
    launches = [("step_kernel", t + 10_000 * i) for i in range(6)]
    events = _events(launches, [1.0] * 6)  # 5 us busy every 10 us
    spans = [("pool.segment", t, t + 25_000, 1), ("pool.segment", t + 30_000, t + 55_000, 1),
             ("s2.job", t + 35_000, t + 80_000, 2), ("pool.pass", t - 5000, t + 90_000, 1)]
    snap = _snapshot(launches, spans)
    reading = _reading(events, t - 10_000, t + 100_000)
    cmap = clock.map_slice(reading, snap)
    b = cmap.device_bounds(t, t + 25_000)
    assert b == pytest.approx((t / 1e3 + OFFSET_US + 1.0, t / 1e3 + OFFSET_US + 26.0))
    idle, total = clock.idle_within(reading.kernels, [b])
    assert (idle, total) == pytest.approx((10.0, 25.0))  # three kernels of 5 us in 25 us
    monkeypatch.setattr(clock, "recorded", lambda: snap)
    run = types.SimpleNamespace(reading=reading)
    assert clock.span_idle_share(run, "pool.segment", {"step_kernel"}) == pytest.approx(40.0)
    # a slice that ends after the second segment's first kernel counts that kernel alone of it
    cut = _reading(events[:4], t - 10_000, t + 30_000 + 10)
    assert clock.span_idle_share(types.SimpleNamespace(reading=cut), "pool.segment", {"step_kernel"}) == \
        pytest.approx(100.0 * 10 / 30)
    split = dict(clock.idle_by_open_span(reading, cmap, snap))
    # five gaps of 5 us: two in the first segment, one between the segments
    # (the pass alone), two in the second under the S2 job on another thread
    assert split == pytest.approx({"pool.segment": 10e-6, "pool.pass": 5e-6, "pool.segment + s2.job": 10e-6})


def window_run(c: bench_run.Cell, seconds: float) -> bench_run.Run:
    """A run's set-up and window, as `bench_run.measure` makes them, without
    the check against the reference: the readers need only the run."""
    run = bench_run.Run(c, SEED)
    run.sentences = traffic.load(c.mix["sentences"])
    family = importlib.import_module(f"bench_port.families.{c.cfg['family']}")
    driver_cls = importlib.import_module(f"bench_port.drivers.{c.mix['driver']}").Driver
    driver = driver_cls(family.build(c.cfg, SEED, "cpu"), c.cfg, c.mix)
    driver.warm(bench_run.warm_requests(c.mix, SEED))
    try:
        bench_run.run_window(run, driver, seconds, False, "cpu")
    finally:
        driver.close()
    return run


@pytest.fixture(scope="module")
def runs():
    """One small CPU run of each cell, on one intra-op thread (light beside
    the other files' whole runs on their workers)."""
    torch.set_num_threads(1)
    v2 = tiny.cell("v2pp.serve.c16", clients=3)
    v4 = tiny.cell("v4.batch.para", shapes=[{"segments": 2, "max_sec": 2}])
    return {c.name: window_run(c, seconds) for c, seconds in ((v2, 2.0), (v4, 2.0))}


NEW = {"v2pp.serve.c16": ["queue_wait_ms", "pool_cpu_ms_per_step", "pool_stall_ms_per_step",
                          "pool_sync_ms_per_step", "pool_live_rows_per_step", "s2_job_ms", "pool_segment_idle"],
       "v4.batch.para": ["dit_step_host_ms", "cfm_idle"]}
SLICE = {"pool_segment_idle", "cfm_idle"}


@pytest.mark.parametrize("cell,metric", [(c, m) for c, ms in NEW.items() for m in ms])
def test_new_readers_on_a_cpu_run(runs, cell, metric):
    run = runs[cell]
    assert run.done, "no request completed in the window"
    value = bench_run.load_metric(metric).read(run)
    if metric in SLICE:
        assert value is None
        return
    assert value is not None and np.isfinite(value) and value >= 0
    if metric == "pool_live_rows_per_step":
        assert 0 < value <= run.cfg["serving"]["slots"]


def test_pool_accounting_on_a_cpu_run(runs):
    """cpu + stall + sync a step is the window's passes' wall a step."""
    run = runs["v2pp.serve.c16"]
    parts = sum(bench_run.load_metric(m).read(run) for m in
                ("pool_cpu_ms_per_step", "pool_stall_ms_per_step", "pool_sync_ms_per_step"))
    p = clock.in_window(clock.recorded().spans_named("pool.pass"), run.t0, run.t_end)
    assert parts == pytest.approx(float((p["t1"] - p["t0"]).sum()) / 1e6 / p["attr"][:, 0].sum())


def test_check_records_accounts_for_the_pool_and_fails_where_it_should(runs):
    """bench_port.check_records on a CPU run: the pool's accounting (its
    parts sum to the passes' wall a step), and the checks that must fail."""
    run = runs["v2pp.serve.c16"]
    names = ("pool_step_ms", "pool_rows_per_step", "pool_cpu_ms_per_step", "pool_stall_ms_per_step",
             "pool_sync_ms_per_step", "pool_live_rows_per_step")
    metrics = {m: bench_run.load_metric(m).read(run) for m in names}
    acct = check_records.accounting(run, {m: v for m, v in metrics.items() if v is not None})
    assert acct is not None and acct["parts_ms_per_step"] == pytest.approx(acct["pass_wall_ms_per_step"])
    result = {"metrics": {m: {"value": v} for m, v in metrics.items() if v is not None}}
    sound = [{"matched": True, "mapped": True}, {"matched": False, "mapped": False}]
    assert check_records.failures(result, sound, {**acct, "share_off": 0.01}, 8) == []
    bad = check_records.failures(result, [{"matched": True, "mapped": False}], {**acct, "share_off": 0.06}, 8)
    assert [b.split(":")[0].split(" by")[0] for b in bad] == ["slice 0", "pool accounting off"]
    low = {"metrics": {"pool_rows_per_step": {"value": 7.5}, "pool_live_rows_per_step": {"value": 7.3}}}
    assert len(check_records.failures(low, [], None, 8)) == 1


def test_check_records_reads_a_slice():
    t = 3_000_000_000
    launches = [("step_kernel", t + 10_000 * i) for i in range(20)]
    reading = _reading(_events(launches, 2.0 + np.arange(20) % 3), t - 1, t + 10**6)
    reading.lib_kernels, reading.launches, reading.busy_s, reading.window_s = 20, 20, 1e-4, 2e-4
    c = check_records.slice_checks(reading, _snapshot(launches, [("pool.segment", t - 5, t + 300_000, 1)]))
    assert c["records_by_kernel"] == c["events_by_kernel"] == {"step_kernel": 20} and c["mapped"]
    assert c["lag_us_median"] == pytest.approx(1.0) and c["lag_us_median_one_offset"] == pytest.approx(1.0)
    assert [k for k, _ in c["idle_by_span"]] == ["pool.segment"]
    spans = check_records.span_sums(_snapshot(launches, [("pool.segment", t, t + 3_000_000, 1),
                                                         ("pool.segment", t, t + 1_000_000, 1)]), t / 1e9, 1.0 + t / 1e9)
    assert spans == {"pool.segment": {"n": 2, "ms": pytest.approx(4.0)}}
