"""snake_aa_roofline: K6's bound over its device time in the traced
request, in %. The bound: the bytes of every K6 launch of the program's
`vocoder.call` spans in the matched slice (each call's frames and rows,
bench_port/flops/bigvgan.py: input and output bf16, alpha and beta f32) at
the memory's bandwidth; the time: the slice's `snake_aa_kernel` events
(csrc/snake_aa.cu)."""

KERNELS = r"\bsnake_aa_kernel\b"


def read(run):
    from bench_port import clock
    from bench_port.flops import bigvgan
    from bench_port.flops.peaks import HBM_BYTES_S

    r = run.reading
    if r is None or not r.matched:
        return None
    snap = clock.recorded()
    if snap is None:
        return None
    sp = snap.spans_named("vocoder.call")
    keep = (sp["t0"] >= clock.ns(r.t0)) & (sp["t1"] <= clock.ns(r.t1))
    nbytes = sum(bigvgan.call(run.cfg["vocoder"], int(a[0]), int(a[1]))["k6_bytes"] for a in sp["attr"][keep])
    device_s = r.kernel_s(KERNELS)
    return 100.0 * nbytes / HBM_BYTES_S / device_s if nbytes > 0 and device_s > 0 else None
