"""queue_wait_ms: the mean milliseconds from a pool segment's enqueue
(`ContinuousBatcher.submit`) to its admission, over the segments admitted
in the window: the program's `pool.queue` spans, one a row, recorded at
admission (their end in the window)."""

from bench_port import clock


def read(run):
    snap = clock.recorded()
    if snap is None:
        return None
    q = clock.in_window(snap.spans_named("pool.queue"), run.t0, run.t_end)
    return float((q["t1"] - q["t0"]).mean()) / 1e6 if len(q["seq"]) else None
