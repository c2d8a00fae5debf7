"""pool_stall_ms_per_step: each scheduler pass's wall time less its thread
CPU time and its time blocked on copies (`pool_sync_ms_per_step`), summed
over the passes that ended in the window, over the pool steps they ran, in
milliseconds: time the scheduler's thread neither ran nor waited on a copy
(waiting for the interpreter lock, for a core, or in a call that sleeps;
the records do not tell which). With `pool_cpu_ms_per_step` and
`pool_sync_ms_per_step` it sums to the passes' wall time a step."""

from bench_port import clock


def read(run):
    snap = clock.recorded()
    if snap is None:
        return None
    p = clock.in_window(snap.spans_named("pool.pass"), run.t0, run.t_end)
    steps = int(p["attr"][:, 0].sum()) if len(p["seq"]) else 0
    if steps <= 0:
        return None
    stall = (p["t1"] - p["t0"] - p["attr"][:, 1] - p["attr"][:, 2]).sum()
    return float(stall) / 1e6 / steps
