"""k1_roofline: the least time the S1 decode steps of the traced slice need
(bench_port/pool.py k1_least_s: from the steps, the decoding rows, their
lengths and the widths, whatever kernel does the work) over the device time
of the kernels that do it in the trace, in %. The kernels counted: K1,
`step_kernel` of csrc/decode_step.cu."""

KERNELS = r"\bstep_kernel\b"


def read(run):
    from bench_port.pool import k1_least_s

    r = run.reading
    if r is None or not r.matched or not run.k1_calls:
        return None
    device_s = r.kernel_s(KERNELS)
    least = k1_least_s(run, r.t0, r.t1)
    return 100.0 * least / device_s if device_s > 0 and least > 0 else None
