"""apbwe_host_share: of the wall time of the program's `apbwe.segment`
spans (one a segment: `super_resolve` and the copy back) that ended in the
window outside the profiled requests, the share in %, spent in their
`apbwe.resample` (the host's polyphase resampling to 48 kHz) and
`apbwe.fetch` (the copy back, which waits for the device's STFT, model and
iSTFT) children; the rest is `apbwe.launch`, issuing that work."""

import numpy as np

PARTS = ("apbwe.resample", "apbwe.fetch")


def read(run):
    from bench_port import clock

    snap = clock.recorded()
    if snap is None:
        return None
    seg = clock.in_window(snap.spans_named("apbwe.segment"), run.t0, run.t_end)
    seg = clock.outside(seg, [(r["sent"], r["done"]) for r in run.records if r.get("profiled")])
    wall = float((seg["t1"] - seg["t0"]).sum())
    if wall <= 0:
        return None
    part = 0.0
    for name in PARTS:
        sp = snap.spans_named(name)
        inside = np.isin(sp["parent"], seg["seq"])
        part += float((sp["t1"] - sp["t0"])[inside].sum())
    return 100.0 * part / wall
