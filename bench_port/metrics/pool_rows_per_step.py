"""pool_rows_per_step: rows that decoded a token, per pool step, over the
window: the benchmark's span around each K1 call (`fused_decode_step`)
records the rows' write slots, and a row decoded at a step where its slot
moved on by one from the step before (a row's first step after it joins is
not seen: a lower bound)."""

from bench_port.pool import live_rows


def read(run):
    calls = [c for c in run.k1_calls if run.t0 <= c[0] <= run.t_end]
    if len(calls) < 2:
        return None
    return sum(len(rows) for rows in live_rows(run.k1_calls, run.t0, run.t_end)) / len(calls)
