"""pool_cpu_ms_per_step: the scheduler thread's CPU time in its passes
(`time.thread_time` over each `ContinuousBatcher.step`, less the CPU time
spent inside the copy waits of `pool_sync_ms_per_step`), summed over
the passes that ended in the window, over the pool steps those passes ran,
in milliseconds (the program's `pool.pass` spans)."""

from bench_port import clock


def read(run):
    snap = clock.recorded()
    if snap is None:
        return None
    p = clock.in_window(snap.spans_named("pool.pass"), run.t0, run.t_end)
    steps = int(p["attr"][:, 0].sum()) if len(p["seq"]) else 0
    return float(p["attr"][:, 1].sum()) / 1e6 / steps if steps > 0 else None
