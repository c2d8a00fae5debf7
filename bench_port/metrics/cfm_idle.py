"""cfm_idle: the device's idle share, in %, inside the traced request's CFM
calls (the program's `cfm.call` spans in the matched slice), each bounded
on the device by the first and last library kernel event paired with its
launch records inside the slice (bench_port/clock.py); idle is the time no
kernel covers."""

from bench_port import clock


def read(run):
    return clock.span_idle_share(run, "cfm.call")
