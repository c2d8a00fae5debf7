"""Checks of the program's records against a traced run, on the card:

    python3 -m bench_port.check_records --workload <cell> --seed <n> --seconds <s> [--trace 0|1] [--enable]

One run, as `bench_port.run` measures it, keeping every slice it profiled.
It prints one JSON line: the run's result (`correct`, the metrics), and for
each slice the library kernels' events and launch records counted kernel by
kernel, whether the clock mapping holds (`bench_port/clock.py`: equal counts,
events in launch order), the median launch-to-start lag through the local
offsets and through the slice's one offset, and the slice's idle time split
by the innermost program span open at each gap; and the program's spans that
ended in the window, counted and summed by name. In `v2pp.serve.c16` also
the pool's accounting: the passes' wall a step (`pool_cpu_ms_per_step` +
`pool_stall_ms_per_step` + `pool_sync_ms_per_step`) against `pool_step_ms`.

It exits 1 where a check fails (each named under `failed`): a matched slice
that does not map (unequal counts or a wrong pairing), passes whose wall a
step is more than 5% off `pool_step_ms`, or `pool_live_rows_per_step` outside
[`pool_rows_per_step` - 0.1, the pool's slots]. `--enable` turns the
recorder's fine records on for the whole run (to time what they cost, with
`--trace 0`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ACCOUNTING = 0.05  # the passes' wall a step may differ from pool_step_ms by this share
ROWS_BELOW = 0.1  # pool_live_rows_per_step may read this far below pool_rows_per_step


def slice_checks(reading, snap) -> dict:
    """What one slice holds against the launch records."""
    from bench_port import clock

    out = {"matched": reading.matched, "lib_kernels": reading.lib_kernels, "launches": reading.launches,
           "busy_s": reading.busy_s, "window_s": reading.window_s}
    la = snap.launches
    inside = (la["t"] >= clock.ns(reading.t0)) & (la["t"] <= clock.ns(reading.t1))
    names = np.array(snap.launch_names(), dtype=object)[inside]
    out["records_by_kernel"] = {k: int((names == k).sum()) for k in sorted(set(names))}
    events: dict = {}
    for name, _, _ in reading.kernels:
        base = clock.kernel_base(name)
        if base is not None:
            events[base] = events.get(base, 0) + 1
    out["events_by_kernel"] = dict(sorted(events.items()))
    cmap = clock.map_slice(reading, snap)
    out["mapped"] = cmap is not None
    if cmap is not None:
        local, single = cmap.lags_us(), cmap.single_lags_us()
        out.update(pairs=int(len(local)), offset_us=cmap.offset_us, lag_us_median=float(np.median(local)),
                   lag_us_median_one_offset=float(np.median(single)),
                   idle_by_span=[[k, v] for k, v in clock.idle_by_open_span(reading, cmap, snap)[:12]])
    return out


def span_sums(snap, t_a: float, t_b: float) -> dict:
    """The spans that ended in [t_a, t_b] (seconds), counted and summed
    (ms) by name."""
    from bench_port import clock

    sp = clock.in_window(snap.spans, t_a, t_b)
    out = {}
    for i in np.unique(sp["name"]):
        d = (sp["t1"] - sp["t0"])[sp["name"] == i]
        out[snap.names[int(i)]] = {"n": int(len(d)), "ms": float(d.sum()) / 1e6}
    return out


def accounting(run, metrics: dict) -> dict | None:
    """The pool's passes over the window against `pool_step_ms`."""
    from bench_port import clock

    snap = clock.recorded()
    if snap is None or "pool_step_ms" not in metrics:
        return None
    p = clock.in_window(snap.spans_named("pool.pass"), run.t0, run.t_end)
    steps = int(p["attr"][:, 0].sum()) if len(p["seq"]) else 0
    if steps <= 0:
        return None
    wall = float((p["t1"] - p["t0"]).sum()) / 1e6 / steps
    parts = sum(metrics.get(m, float("nan")) for m in
                ("pool_cpu_ms_per_step", "pool_stall_ms_per_step", "pool_sync_ms_per_step"))
    return {"passes": int(len(p["seq"])), "steps": steps, "pass_wall_ms_per_step": wall,
            "parts_ms_per_step": parts, "pool_step_ms": metrics["pool_step_ms"],
            "share_off": parts / metrics["pool_step_ms"] - 1.0}


def failures(result: dict, slices: list, acct: dict | None, slots: int | None) -> list:
    bad = []
    for i, c in enumerate(slices):
        if c["matched"] and not c["mapped"]:
            bad.append(f"slice {i}: matched but not mapped")
    if acct is not None and not abs(acct["share_off"]) <= ACCOUNTING:
        bad.append(f"pool accounting off by {acct['share_off']:+.4f}")
    m = {k: v["value"] for k, v in result["metrics"].items()}
    if "pool_live_rows_per_step" in m and "pool_rows_per_step" in m:
        live = m["pool_live_rows_per_step"]
        if not m["pool_rows_per_step"] - ROWS_BELOW <= live <= (slots or float("inf")):
            bad.append(f"pool_live_rows_per_step {live} against pool_rows_per_step {m['pool_rows_per_step']}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--enable", action="store_true")
    args = ap.parse_args(argv)

    root = Path.cwd()
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    import torch

    from bench_port import clock, trace
    from bench_port import run as bench_run

    torch.set_num_threads(1)  # as bench_port/run.py
    cell = bench_run.Cell(bench_run.load_json(root / "BENCHMARK.json"), args.workload)
    if args.enable:
        from gpt_sovits_tpu_torch.utils.metrics import recorder

        recorder().enable()
    readings = []
    read = trace.Slice.read

    def keep(sl):
        r = read(sl)
        readings.append(r)
        return r

    trace.Slice.read = keep
    try:
        result, run = bench_run.measure(cell, args.seed, args.seconds, bool(args.trace))
    finally:
        trace.Slice.read = read
    snap = clock.recorded()
    slices = [slice_checks(r, snap) for r in readings] if snap is not None else []
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    acct = accounting(run, metrics) if args.trace else None
    bad = failures(result, slices, acct, cell.cfg.get("serving", {}).get("slots"))
    spans = span_sums(snap, run.t0, run.t_end) if snap is not None else {}
    print(json.dumps({"workload": args.workload, "seed": args.seed, "trace": args.trace, "enable": args.enable,
                      "correct": result["correct"], "failed_requests": result["failed"], "metrics": metrics,
                      "device": result["device"], "accounting": acct, "slices": slices, "spans": spans,
                      "failed": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
