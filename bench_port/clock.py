"""The program's own records (the port's recorder, `gpt_sovits_tpu_torch/
utils/metrics.py`) read by the benchmark, and its spans put on the clock of
a traced slice's kernel events.

The recorder stamps spans, counters and launch records with
`time.perf_counter_ns()`, the benchmark's own clock (`run.t0`, `run.t_end`
are `perf_counter` seconds). A slice's kernel events (`trace.Reading
.kernels`) are microseconds on the profiler's clock. While the slice is
profiled, the port's CUDA-library wrappers record each launch (the device
kernel's name, the host time just before the launch). The i-th launch
record of a kernel inside the slice is paired with the i-th event of that
kernel; a slice holds exactly as many such events as the libraries counted
launches, so the counts must agree kernel by kernel. In both cells one
thread launches every library kernel onto one stream, so the device runs
them in launch order: a pairing whose events, taken in launch order across
kernels, start out of order is wrong, and the slice is refused. A kernel cannot start
before its launch, so the offset from the host clock to the profiler's is
the smallest event start minus launch record: it is off by the smallest
launch latency only.

One offset for a whole slice is not enough. On the H100 machine the
profiler's timestamps drift against `perf_counter_ns` by up to 1.5% over a
two-second slice, and not at a steady rate (a v4 request's slice: 34 ms
between its ends, 9 ms of it inside the CFM call alone, while the device
was idle 75% of the call, so the true lags were tens of microseconds). So
the start-minus-launch differences are first put on a line below them all
(the lower convex hull's edge under their mean launch time: the steady
rate), and each pair then gets a local offset, the line plus the smallest
difference above it over the `LOCAL_PAIRS` pairs on either side in launch
order. Host times are mapped through those local offsets, interpolated
between pairs. `offset_us` keeps the single smallest difference. A local
offset lies on or above the line by construction, so no kernel then starts
before its mapped launch: that is no check. Where the device runs behind a
deep launch queue (a v4 slice whose CFM kept the card busy), every
difference near a pair holds the queue's delay too, and its local offset
with it: the mapping is then late by that delay, which moves only the short
gaps between queued kernels. The kernel that ends an idle gap was launched
into an empty queue, so around the gaps the idle split is read at, the
local offsets hold the launch latency alone.

A program without the recorder (an older tree) gives `recorded()` None, and
every reader built on it returns None.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from bench_port.trace import LIB_KERNELS

LOCAL_PAIRS = 8  # pairs on either side whose smallest start minus launch is a pair's local offset
# spans that time a request's wait, not work on the thread that records them
WAIT_SPANS = ("pool.queue",)


def recorded():
    """A snapshot of the port's recorder, or None where the program has none."""
    try:
        from gpt_sovits_tpu_torch.utils.metrics import recorder
    except ImportError:
        return None
    try:
        return recorder().snapshot()
    except AttributeError:
        return None


def ns(t_s: float) -> int:
    """A `perf_counter` reading in seconds as `perf_counter_ns`."""
    return int(round(t_s * 1e9))


def in_window(spans: dict, t_a: float, t_b: float) -> dict:
    """The spans that end in [t_a, t_b] (seconds)."""
    keep = (spans["t1"] >= ns(t_a)) & (spans["t1"] <= ns(t_b))
    return {c: v[keep] for c, v in spans.items()}


def outside(spans: dict, intervals: list) -> dict:
    """The spans that overlap none of the (start, end) intervals (seconds)."""
    keep = np.ones(len(spans["seq"]), bool)
    for a, b in intervals:
        keep &= (spans["t1"] < ns(a)) | (spans["t0"] > ns(b))
    return {c: v[keep] for c, v in spans.items()}


def kernel_base(name: str) -> str | None:
    """The library kernel a device event belongs to, as the recorder names
    it (`step_kernel`, `row_quant_kernel`, ...), or None."""
    m = LIB_KERNELS.search(name)
    return m.group(1) if m else None


class ClockMap:
    """A slice's launch records paired with its library kernel events.
    `pairs[kernel]` holds the records' host times (ns) and the paired
    events' starts and ends (us, profiler's clock), in launch order."""

    def __init__(self, pairs: dict):
        self.pairs = pairs
        t = np.concatenate([t for t, _, _ in pairs.values()])
        starts = np.concatenate([ev_s for _, ev_s, _ in pairs.values()])
        order = np.argsort(t, kind="stable")
        self._t, starts = t[order].astype(np.float64), starts[order]
        # events that start before the event of an earlier launch
        self.inversions = int((np.diff(starts) < 0).sum())
        d = starts - self._t / 1e3  # start minus launch
        self.offset_us = float(d.min())
        line = _floor_line(self._t, d)
        padded = np.pad(d - line, LOCAL_PAIRS, constant_values=np.inf)
        self._local = line + np.lib.stride_tricks.sliding_window_view(padded, 2 * LOCAL_PAIRS + 1).min(axis=1)

    def to_device(self, t_ns) -> np.ndarray:
        """Host `perf_counter_ns` times on the profiler's clock (us), through
        the local offsets (the nearest pair's at either end)."""
        t = np.asarray(t_ns, dtype=np.float64)
        return t / 1e3 + np.interp(t, self._t, self._local)

    def lags_us(self) -> np.ndarray:
        """Each kernel's start after its launch record, beyond the smallest
        such lag among its neighbours (>= 0)."""
        return np.concatenate([ev_s - self.to_device(t) for t, ev_s, _ in self.pairs.values()])

    def single_lags_us(self) -> np.ndarray:
        """Each kernel's start after its launch record through the one
        offset of the slice, beyond the slice's smallest lag (>= 0; the
        drift adds to it)."""
        return np.concatenate([ev_s - t / 1e3 - self.offset_us for t, ev_s, _ in self.pairs.values()])

    def device_bounds(self, t0_ns: int, t1_ns: int, kernels=None) -> tuple | None:
        """The first start and last end (us) of the paired events whose
        launch records lie in [t0_ns, t1_ns], of the named kernels (every
        library kernel by default); None where there is none."""
        first, last = np.inf, -np.inf
        for name, (t, ev_s, ev_e) in self.pairs.items():
            if kernels is not None and name not in kernels:
                continue
            k = (t >= t0_ns) & (t <= t1_ns)
            if k.any():
                first, last = min(first, float(ev_s[k].min())), max(last, float(ev_e[k].max()))
        return (first, last) if first < last else None


def _floor_line(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The line below every point (x sorted) that runs along the lower
    convex hull's edge under the points' mean x, evaluated at x."""
    hull: list = []
    for p in zip(x.tolist(), y.tolist()):
        while len(hull) >= 2 and ((hull[-1][0] - hull[-2][0]) * (p[1] - hull[-2][1])
                                  - (hull[-1][1] - hull[-2][1]) * (p[0] - hull[-2][0])) <= 0:
            hull.pop()
        hull.append(p)
    xm = float(x.mean())
    for (x0, y0), (x1, y1) in zip(hull, hull[1:]):
        if x0 <= xm <= x1 and x1 > x0:
            return y0 + (y1 - y0) / (x1 - x0) * (x - x0)
    return np.full_like(y, y.min())


def map_slice(reading, snap) -> ClockMap | None:
    """Pair the slice's launch records (host time in the slice's [t0, t1])
    with its library kernel events, kernel by kernel in order. None where
    the recorder is missing, the slice holds no library kernel, the counts
    differ for any kernel (an unmatched slice is refused), or the paired
    events run out of launch order (a wrong pairing)."""
    if snap is None or reading is None:
        return None
    la = snap.launches
    names = np.array(snap.launch_names(), dtype=object)
    inside = (la["t"] >= ns(reading.t0)) & (la["t"] <= ns(reading.t1))
    recs = defaultdict(list)
    for name, t in zip(names[inside], la["t"][inside]):
        recs[name].append(int(t))
    events = defaultdict(list)
    for name, s, e in reading.kernels:
        base = kernel_base(name)
        if base is not None:
            events[base].append((s, e))
    if not events or set(recs) != set(events):
        return None
    pairs = {}
    for name, ts in recs.items():
        ev = sorted(events[name])
        if len(ev) != len(ts):
            return None
        pairs[name] = (np.array(sorted(ts), dtype=np.int64), np.array([s for s, _ in ev], dtype=np.float64),
                       np.array([e for _, e in ev], dtype=np.float64))
    cmap = ClockMap(pairs)
    return cmap if cmap.inversions == 0 else None


def merged_kernels(kernels) -> tuple:
    """The union of the kernel intervals (us) as sorted starts and ends."""
    out = []
    for s, e in sorted((s, e) for _, s, e in kernels):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    arr = np.array(out, dtype=np.float64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


def idle_within(kernels, intervals) -> tuple:
    """(idle us, length us) summed over the (start, end) intervals (us):
    the time in them that no kernel covers, and their length."""
    starts, ends = merged_kernels(kernels)
    idle = total = 0.0
    for a, b in intervals:
        busy = np.clip(np.minimum(ends, b) - np.maximum(starts, a), 0.0, None).sum()
        total += b - a
        idle += (b - a) - busy
    return idle, total


def span_idle_share(run, name: str, kernels=None) -> float | None:
    """The device's idle share (%) inside the spans called `name` in the
    run's matched slice, each bounded on the device by the first and last
    event of its launches inside the slice (of `kernels`, default every
    library kernel): a span cut by the slice's edge counts its part in it."""
    r = run.reading
    if r is None or not r.matched:
        return None
    snap = recorded()
    cmap = map_slice(r, snap)
    if cmap is None:
        return None
    sp = snap.spans_named(name)
    keep = (sp["t1"] >= ns(r.t0)) & (sp["t0"] <= ns(r.t1))
    bounds = [cmap.device_bounds(int(a), int(b), kernels) for a, b in zip(sp["t0"][keep], sp["t1"][keep])]
    bounds = [b for b in bounds if b is not None]
    if not bounds:
        return None
    idle, total = idle_within(r.kernels, bounds)
    return 100.0 * idle / total if total > 0 else None


def idle_by_open_span(reading, cmap: ClockMap, snap) -> list:
    """The slice's idle gaps (between the merged kernel intervals), each
    put down to the innermost program span open at its middle on each
    thread (the latest-started open span of that thread; `WAIT_SPANS` left
    out), the threads' names joined by " + " ("no program span" where none
    is open); the sums in seconds, largest first."""
    starts, ends = merged_kernels(reading.kernels)
    if len(starts) < 2:
        return []
    gaps_a, gaps_b = ends[:-1], starts[1:]
    keep = gaps_b > gaps_a
    gaps_a, gaps_b = gaps_a[keep], gaps_b[keep]
    sp = snap.spans
    t0 = cmap.to_device(sp["t0"])
    t1 = np.where(sp["t1"] > 0, cmap.to_device(sp["t1"]), np.inf)
    waits = [snap.names.index(n) for n in WAIT_SPANS if n in snap.names]
    win = (t1 >= gaps_a.min()) & (t0 <= gaps_b.max()) & ~np.isin(sp["name"], waits)
    t0, t1, names, threads = t0[win], t1[win], sp["name"][win], sp["thread"][win]
    out = defaultdict(float)
    for a, b in zip(gaps_a, gaps_b):
        mid = (a + b) / 2
        on = np.flatnonzero((t0 <= mid) & (t1 >= mid))
        inner = {}
        for k in on[np.argsort(t0[on], kind="stable")]:  # later starts overwrite: the innermost per thread
            inner[int(threads[k])] = snap.names[names[k]]
        label = " + ".join(sorted(set(inner.values()))) or "no program span"
        out[label] += (b - a) / 1e6
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])
