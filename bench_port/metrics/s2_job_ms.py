"""s2_job_ms: the mean milliseconds of wall time a finisher thread spends on
a job (`ContinuousTTSService._finish_job`: S2's launch, the fetch of its
audio and the join), over the jobs it completed in the window (the
program's `s2.job` spans, their end in the window)."""

from bench_port import clock


def read(run):
    snap = clock.recorded()
    if snap is None:
        return None
    j = clock.in_window(snap.spans_named("s2.job"), run.t0, run.t_end)
    return float((j["t1"] - j["t0"]).mean()) / 1e6 if len(j["seq"]) else None
