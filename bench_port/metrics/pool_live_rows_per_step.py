"""pool_live_rows_per_step: rows that decoded a token, per pool step, over
the window: the program's `pool.decoded_row_steps` counter (each installed
row's growth in length between two flag copies, as the copies read it,
stamped at the later copy's capture) summed over the copies captured in the
window, over the steps of the pool segments that ended in it. Exact where
`pool_rows_per_step` is a lower bound."""

from bench_port import clock


def read(run):
    snap = clock.recorded()
    if snap is None:
        return None
    c = snap.counts_named("pool.decoded_row_steps")
    inside = (c["t"] >= clock.ns(run.t0)) & (c["t"] <= clock.ns(run.t_end))
    seg = clock.in_window(snap.spans_named("pool.segment"), run.t0, run.t_end)
    steps = int(seg["attr"][:, 0].sum()) if len(seg["seq"]) else 0
    return float(c["value"][inside].sum()) / steps if steps > 0 else None
