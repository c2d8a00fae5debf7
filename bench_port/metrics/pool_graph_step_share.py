"""pool_graph_step_share: the share of the S1 pool's steps, in %, whose tail
(everything after K1: the head, the sampler, the state updates) ran as a
CUDA graph replay: the program's `pool.graph_steps` counter, stamped inside
each `pool.segment` span, summed over the segments that ended in the window,
over their steps. None from a program without that counter."""

import numpy as np

from bench_port import clock


def read(run):
    snap = clock.recorded()
    if snap is None or "pool.graph_steps" not in snap.names:
        return None
    seg = clock.in_window(snap.spans_named("pool.segment"), run.t0, run.t_end)
    steps = int(seg["attr"][:, 0].sum()) if len(seg["seq"]) else 0
    if steps <= 0:
        return None
    order = np.argsort(seg["t0"], kind="stable")
    t0, t1 = seg["t0"][order], seg["t1"][order]
    c = snap.counts_named("pool.graph_steps")
    k = np.searchsorted(t0, c["t"], side="right") - 1  # the latest segment begun at or before each count
    inside = (k >= 0) & (c["t"] <= t1[np.maximum(k, 0)])
    return 100.0 * float(c["value"][inside].sum()) / steps
