"""The traced slice of a `--trace 1` run, and what is read from it.

A slice is a bounded stretch of the measured window under torch.profiler
(CUPTI), entered and left at a device sync. In a long process the profiler
has been seen to drop kernel events, so a slice counts only where the
kernels of the port's CUDA libraries that it holds are exactly as many as
the libraries counted launches over it (`launch_counts()` of ops/*.py).

From a slice: `busy_s`, the union of the kernels' intervals; `window_s`, the
slice's length on the profiler's clock (its first event to its last); the kernels' device time by name; and the
longest idle gaps between kernels, each labelled by the innermost host
operation the profiler saw running at its middle.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

import numpy as np
import torch

# the kernels of the port's CUDA libraries, as their sources name them
LIB_KERNELS = re.compile(r"\b(step_kernel|row_quant_kernel|qdense_wgmma_kernel|qkv_rope_wgmma_kernel|"
                         r"v_quant_kernel|flash_attn_wgmma_kernel|snake_aa_kernel)\b")
NAME_CHARS = 120
LABELLED_GAPS = 200


def launch_totals() -> int:
    """Launches the port's CUDA libraries have counted so far."""
    from gpt_sovits_tpu_torch.ops import decode_step, qflash, qmatmul, snake_aa

    return sum(sum(m.launch_counts().values()) for m in (decode_step, qflash, qmatmul, snake_aa))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Reading:
    """What one slice holds."""

    def __init__(self, events, launches: int, t0: float, t1: float):
        from torch.autograd import DeviceType

        self.t0, self.t1 = t0, t1
        self.kernels = []  # (name, start_us, end_us)
        cpu = []
        first, last = float("inf"), float("-inf")
        for e in events:
            s, f = e.time_range.start, e.time_range.end
            first, last = min(first, s), max(last, f)
            if getattr(e, "is_user_annotation", False):
                continue
            if e.device_type == DeviceType.CUDA and f > s:
                self.kernels.append((e.name, s, f))
            elif e.device_type == DeviceType.CPU and f > s:
                cpu.append((e.name, s, f))
        # the slice on the profiler's own clock: its first event to its last
        self.window_s = max(0.0, last - first) / 1e6
        self.launches = launches
        self.lib_kernels = sum(1 for k in self.kernels if LIB_KERNELS.search(k[0]))
        self.matched = bool(self.kernels) and self.lib_kernels == launches
        merged = _merge([(s, f) for _, s, f in self.kernels])
        self.busy_s = sum(f - s for s, f in merged) / 1e6
        by_name = defaultdict(float)
        for name, s, f in self.kernels:
            by_name[name[:NAME_CHARS]] += (f - s) / 1e6
        self.device_ops = sorted(([n, v] for n, v in by_name.items()), key=lambda kv: -kv[1])[:10]
        self.idle_gaps = self._label_gaps(merged, cpu)

    @staticmethod
    def _label_gaps(merged, cpu, longest: int = LABELLED_GAPS):
        """The `longest` idle gaps between kernels, summed by the innermost
        host operation running at each gap's middle; the ten largest sums."""
        gaps = sorted(((b - a, (a + b) / 2) for (_, a), (b, _) in zip(merged, merged[1:])), reverse=True)[:longest]
        starts = np.array([s for _, s, _ in cpu], dtype=np.float64)
        ends = np.array([f for _, _, f in cpu], dtype=np.float64)
        out = defaultdict(float)
        for length, mid in gaps:
            on = np.flatnonzero((starts <= mid) & (ends >= mid))
            label = cpu[on[np.argmin(ends[on] - starts[on])]][0][:NAME_CHARS] if on.size else "no host operation traced"
            out[label] += length / 1e6
        return sorted(([n, v] for n, v in out.items()), key=lambda kv: -kv[1])[:10]

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose names match `pattern`."""
        rx = re.compile(pattern)
        return sum(f - s for n, s, f in self.kernels if rx.search(n)) / 1e6


class Slice:
    """`with Slice() as sl:` profiles the block; `sl.read()` afterwards
    reads it. The profiler's events are processed only then, so that a slice
    read after the window takes no host time from the work it measures."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.c0 = launch_totals()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.c1 = launch_totals()
        self.prof.__exit__(*exc)
        return False

    def read(self) -> Reading:
        return Reading(self.prof.events(), self.c1 - self.c0, self.t0, self.t1)
