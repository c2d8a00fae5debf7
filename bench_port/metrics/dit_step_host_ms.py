"""dit_step_host_ms: the mean milliseconds of host wall time to issue one
Euler step of the CFM (the program's `cfm.step` spans in `cfm_inference`),
over the steps taken in the window outside the profiled requests."""

from bench_port import clock


def read(run):
    snap = clock.recorded()
    if snap is None:
        return None
    steps = clock.in_window(snap.spans_named("cfm.step"), run.t0, run.t_end)
    steps = clock.outside(steps, [(r["sent"], r["done"]) for r in run.records if r.get("profiled")])
    return float((steps["t1"] - steps["t0"]).mean()) / 1e6 if len(steps["seq"]) else None
