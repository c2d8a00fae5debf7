"""pool_segment_idle: the device's idle share, in %, inside the S1 pool's
segments (the program's `pool.segment` spans around each run of 25 steps)
in the matched traced slice. Each segment is bounded on the device by the
first and last K1 event (`step_kernel`) paired with its launch records
inside the slice (bench_port/clock.py); idle is the time no kernel covers."""

from bench_port import clock


def read(run):
    return clock.span_idle_share(run, "pool.segment", kernels={"step_kernel"})
