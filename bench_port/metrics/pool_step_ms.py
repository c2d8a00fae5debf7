"""pool_step_ms: the window's seconds over the pool steps run in it (the
change of `ContinuousBatcher.steps_run`), in milliseconds."""


def read(run):
    steps = run.counters1.get("pool_steps", 0) - run.counters0.get("pool_steps", 0)
    return 1e3 * (run.t_end - run.t0) / steps if steps > 0 else None
