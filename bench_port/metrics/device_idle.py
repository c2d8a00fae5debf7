"""device_idle: the share of the traced slice in which no kernel ran, in %;
only a slice whose kernel events match the port's launch counts counts."""


def read(run):
    r = run.reading
    if r is None or not r.matched or r.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - r.busy_s / r.window_s)
