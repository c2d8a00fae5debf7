"""pool_sync_ms_per_step: the scheduler's wall time blocked on copies (the
flag and token copies' events, `pool.sync_flags` and `pool.sync_tokens`,
and the admissions' plain uploads, `pool.sync_upload`, which wait for the
stream to drain), summed over the passes that ended in the window, over
the pool steps they ran, in milliseconds (the program's `pool.pass`
spans)."""

from bench_port import clock


def read(run):
    snap = clock.recorded()
    if snap is None:
        return None
    p = clock.in_window(snap.spans_named("pool.pass"), run.t0, run.t_end)
    steps = int(p["attr"][:, 0].sum()) if len(p["seq"]) else 0
    return float(p["attr"][:, 2].sum()) / 1e6 / steps if steps > 0 else None
