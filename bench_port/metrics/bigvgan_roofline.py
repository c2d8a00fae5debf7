"""bigvgan_roofline: the least time the traced request's BigVGAN calls need
over the device's busy time in them, in %. A call is the program's
`vocoder.call` span in the matched slice (attributes: the mel's frames and
rows), bounded on the device by its first and last K6 event
(`snake_aa_kernel`, paired with its launch records: bench_port/clock.py);
its least time is the work between those two launches (bench_port/flops/
bigvgan.py "inner": every AMP block's convolutions and the transposed
convolutions after the first, at the bf16 peak; every K6 launch's bytes at
the memory's bandwidth). The input convolution, the first transposed
convolution and the output convolution lie outside the bounds and are left
out of both."""

K6 = {"snake_aa_kernel"}


def read(run):
    from bench_port import clock
    from bench_port.flops import bigvgan
    from bench_port.flops.peaks import HBM_BYTES_S, compute_s

    r = run.reading
    if r is None or not r.matched:
        return None
    snap = clock.recorded()
    cmap = clock.map_slice(r, snap)
    if cmap is None:
        return None
    sp = snap.spans_named("vocoder.call")
    keep = (sp["t0"] >= clock.ns(r.t0)) & (sp["t1"] <= clock.ns(r.t1))
    least, bounds = 0.0, []
    for t0, t1, (frames, rows, _, _) in zip(sp["t0"][keep], sp["t1"][keep], sp["attr"][keep]):
        b = cmap.device_bounds(int(t0), int(t1), K6)
        if b is None:
            continue
        work = bigvgan.call(run.cfg["vocoder"], int(frames), int(rows))
        least += compute_s(work["ops"]["inner"], run.cfg["precision"]["vocoder"]) + work["k6_bytes"] / HBM_BYTES_S
        bounds.append(b)
    if not bounds:
        return None
    idle, total = clock.idle_within(r.kernels, bounds)
    busy_s = (total - idle) / 1e6
    return 100.0 * least / busy_s if busy_s > 0 else None
