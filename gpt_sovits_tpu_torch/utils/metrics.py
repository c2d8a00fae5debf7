"""Metrics logging, phase timing, throughput counters, the in-program
recorder of spans and counters, and a profiler hook (port of
gpt_sovits_tpu/utils/metrics.py: MetricsLogger, PhaseTimer, ThroughputMeter;
`profile_trace` on torch.profiler where the JAX package uses jax.profiler).

The recorder (`recorder()`, one a process) keeps what the serving pool,
the S2 finishers, the pipeline's phases, S1's `generate`, the CFM and the
CUDA libraries' wrappers did, in bounded rings preallocated at start-up:

  * spans: name, start and end on `time.perf_counter_ns()`, the thread
    (its native id, as torch.profiler names threads), the span enclosing
    it on that thread, the request it serves (a job's id, or a pool
    segment's rid) and up to four integer attributes;
  * counters: a name, a time and a value;
  * launches: one record a launch of a port CUDA-library kernel (its
    device kernel's name and the host time just before the launch).

Coarse records (spans, counters) are always taken: a few clock
reads a pool pass, admission, S2 job, CFM call, Euler step and phase.
Fine records (launches, one span a `generate` step) are taken only while
tracing is on: after `enable()`, or while a torch.profiler session runs
anywhere in the process. Off, each costs one flag check. Nothing here
syncs the device; the rings overwrite their oldest rows when full.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_ATTRS = 4  # integer attributes a span carries


def _profiler_running() -> bool:
    """Whether a torch.profiler session is active anywhere in the process.
    `torch._C._autograd._profiler_enabled()` answers for the calling thread
    only; this private module flag is process-wide, so it is read with a
    default in case a release drops it."""
    return bool(getattr(_autograd_profiler, "_is_profiler_enabled", False))


class _Ring:
    """A bounded table of int64 columns whose rows are handed out in
    sequence (1, 2, ...) and overwritten oldest first. `seq` 0 marks a row
    never written or being written."""

    def __init__(self, capacity: int, columns: tuple, wide: dict | None = None):
        if capacity < 1 or capacity & (capacity - 1):
            raise ValueError(f"ring capacity must be a power of two, got {capacity}")
        self.mask = capacity - 1
        self.columns = ("seq",) + columns
        self.next = itertools.count(1).__next__  # atomic under the interpreter lock
        for c in self.columns:
            setattr(self, c, np.zeros(capacity, np.int64))
        self.wide = dict(wide or {})
        for c, width in self.wide.items():
            setattr(self, c, np.zeros((capacity, width), np.int64))

    def table(self) -> dict:
        """Copies of the written rows, in sequence order."""
        seq = self.seq.copy()
        keep = np.flatnonzero(seq > 0)
        order = keep[np.argsort(seq[keep], kind="stable")]
        return {c: getattr(self, c)[order].copy() for c in self.columns + tuple(self.wide)}


class Snapshot:
    """The recorder's rings as numpy columns, in sequence order, with names
    resolved. Span times are `perf_counter_ns` integers; `t1` is 0 for a
    span still open."""

    def __init__(self, names: list, spans: dict, counts: dict, launches: dict):
        self.names = list(names)
        self.spans, self.counts, self.launches = spans, counts, launches

    def _ids(self, name: str) -> int:
        return self.names.index(name) if name in self.names else -1

    def spans_named(self, name: str) -> dict:
        """The closed spans of one name."""
        keep = (self.spans["name"] == self._ids(name)) & (self.spans["t1"] > 0)
        return {c: v[keep] for c, v in self.spans.items()}

    def counts_named(self, name: str) -> dict:
        keep = self.counts["name"] == self._ids(name)
        return {c: v[keep] for c, v in self.counts.items()}

    def launch_names(self) -> list:
        """The launch records' kernel names, one a record."""
        return [self.names[i] for i in self.launches["name"]]


class Recorder:
    """Spans, counters and launch records of the whole process
    (module docstring). `begin`/`end` bracket a span on the calling thread,
    `record` writes a closed one whose times the caller read, `mark` a
    zero-length one; `count` adds a counter row; `launch` a fine launch
    record while tracing is on (`fine()`)."""

    def __init__(self, spans: int = 1 << 16, counts: int = 1 << 16, launches: int = 1 << 18):
        self._names: dict = {}
        self._name_list: list = []
        self._names_lock = threading.Lock()
        self._local = threading.local()
        self._enabled = False
        self._spans = _Ring(spans, ("name", "t0", "t1", "thread", "parent", "rid"), {"attr": SPAN_ATTRS})
        self._counts = _Ring(counts, ("name", "t", "value"))
        self._launches = _Ring(launches, ("name", "t"))

    # -- switches -----------------------------------------------------------

    def enable(self) -> None:
        """Turn fine records on until `disable()`."""
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def fine(self) -> bool:
        """Whether tracing is on: after `enable()`, or while a torch.profiler
        session is active on any thread."""
        return self._enabled or _profiler_running()

    def intern(self, name: str) -> int:
        """The small integer that stands for `name` in the rings."""
        i = self._names.get(name)
        if i is None:
            with self._names_lock:
                i = self._names.setdefault(name, len(self._name_list))
                if i == len(self._name_list):
                    self._name_list.append(name)
        return i

    # -- spans ----------------------------------------------------------------

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _thread(self) -> int:
        """This thread's native id, read once a thread (a system call: up to
        15 us on a virtualised host)."""
        try:
            return self._local.thread
        except AttributeError:
            self._local.thread = threading.get_native_id()
            return self._local.thread

    def _write_span(self, name: int, t0: int, t1: int, rid: int, attrs: tuple) -> int:
        r = self._spans
        seq = r.next()
        i = seq & r.mask
        stack = self._stack()
        r.seq[i] = 0
        r.name[i] = name
        r.t0[i] = t0
        r.t1[i] = t1
        r.thread[i] = self._thread()
        r.parent[i] = stack[-1] if stack else 0
        r.rid[i] = rid
        row = r.attr[i]
        row[:] = 0
        for k, v in enumerate(attrs):
            row[k] = v
        r.seq[i] = seq
        return seq

    def begin(self, name: int, rid: int = -1) -> int:
        """Open a span of the interned `name` on this thread; returns its
        sequence number, which `end` takes."""
        seq = self._write_span(name, time.perf_counter_ns(), 0, rid, ())
        self._stack().append(seq)
        return seq

    def end(self, seq: int, *attrs: int) -> int:
        """Close the span `seq` (setting its attributes, where given); returns
        its length in ns (0 where the ring has overwritten it)."""
        t1 = time.perf_counter_ns()
        stack = self._stack()
        if stack and stack[-1] == seq:
            stack.pop()
        elif seq in stack:  # spans opened inside it and left open (an exception) close with it
            del stack[stack.index(seq):]
        r = self._spans
        i = seq & r.mask
        if r.seq[i] != seq:
            return 0
        r.t1[i] = t1
        row = r.attr[i]
        for k, v in enumerate(attrs):
            row[k] = v
        return t1 - int(r.t0[i])

    def record(self, name: int, t0: int, t1: int, rid: int = -1, *attrs: int) -> int:
        """A closed span whose times (`perf_counter_ns`) the caller read,
        inside the span open on this thread."""
        return self._write_span(name, t0, t1, rid, attrs)

    def mark(self, name: int, rid: int = -1, *attrs: int) -> int:
        """A zero-length span now: an event."""
        t = time.perf_counter_ns()
        return self._write_span(name, t, t, rid, attrs)

    @contextlib.contextmanager
    def span(self, name: str, rid: int = -1):
        """`with rec.span("name", rid):` brackets the block (for code off
        the per-step paths, which call `begin`/`end`)."""
        seq = self.begin(self.intern(name), rid)
        try:
            yield seq
        finally:
            self.end(seq)

    # -- counters, launches -----------------------------------------------

    def count(self, name: int, value: int, t: int | None = None) -> None:
        """A counter row: `value` of the interned `name` at `t` (now)."""
        r = self._counts
        seq = r.next()
        i = seq & r.mask
        r.seq[i] = 0
        r.name[i] = name
        r.t[i] = time.perf_counter_ns() if t is None else t
        r.value[i] = value
        r.seq[i] = seq

    def launch(self, kernel: int) -> None:
        """While tracing is on, one record of a launch of the interned device
        kernel `kernel` (call it just before the launch)."""
        if not (self._enabled or _profiler_running()):
            return
        r = self._launches
        seq = r.next()
        i = seq & r.mask
        r.seq[i] = 0
        r.name[i] = kernel
        r.t[i] = time.perf_counter_ns()
        r.seq[i] = seq

    # -- reading ----------------------------------------------------------------

    def snapshot(self) -> Snapshot:
        """Copies of every ring (rows being written are left out)."""
        return Snapshot(self._name_list, self._spans.table(), self._counts.table(), self._launches.table())


_RECORDER = Recorder()
_REQUEST_IDS = itertools.count(1)


def recorder() -> Recorder:
    """The process's recorder."""
    return _RECORDER


def next_request_id() -> int:
    """A request id unique in the process (a job's or a pipeline run's)."""
    return next(_REQUEST_IDS)


class MetricsLogger:
    """Append-only JSONL scalars (`{log_dir}/{name}.jsonl`, one record a
    call: step, time and the scalars), plus TensorBoard scalars when
    `torch.utils.tensorboard` imports."""

    def __init__(self, log_dir: str, name: str = "metrics", *, echo: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self.echo = echo
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional
            pass
        else:
            self._tb = SummaryWriter(log_dir)

    def log(self, step: int, **scalars) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))
        if self.echo:
            parts = " ".join(f"{k}={float(v):.4g}" for k, v in scalars.items())
            print(f"[step {step}] {parts}")

    def close(self):
        if self._tb is not None:
            self._tb.close()


class PhaseTimer:
    """Named phase timing (the reference's hand-rolled t0..t5 lines): each
    phase is a span `phase.<name>` of the recorder, with the request's id;
    `phases` sums their lengths in seconds by name (a phase whose block
    raised is left out)."""

    def __init__(self, rid: int = -1):
        self.phases: dict[str, float] = {}
        self.rid = rid

    @contextlib.contextmanager
    def phase(self, name: str):
        rec = _RECORDER
        seq = rec.begin(rec.intern(f"phase.{name}"), self.rid)
        try:
            yield
        finally:
            ns = rec.end(seq)
        self.phases[name] = self.phases.get(name, 0.0) + ns / 1e9

    def report(self) -> str:
        total = sum(self.phases.values())
        parts = [f"{k}:{v:.3f}s" for k, v in self.phases.items()]
        return f"{' '.join(parts)} total:{total:.3f}s"


@dataclass
class ThroughputMeter:
    """Audio seconds synthesized against wall seconds summed over requests,
    and per chip (`n_chips`). The wall seconds are each request's own
    (its phases), added up: requests that ran at the same time count their
    common seconds more than once, so this is not a window's clock."""

    n_chips: int = 1
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0

    @contextlib.contextmanager
    def measure(self, audio_seconds: float):
        """Time the block as one request of `audio_seconds` of audio."""
        t0 = time.perf_counter()
        yield
        self.wall_seconds += time.perf_counter() - t0
        self.audio_seconds += audio_seconds

    def measure_done(self, audio_seconds: float, wall_seconds: float) -> None:
        """Record an already-timed request (phases measured elsewhere)."""
        self.audio_seconds += audio_seconds
        self.wall_seconds += wall_seconds

    @property
    def rtf(self) -> float:
        return self.wall_seconds / max(self.audio_seconds, 1e-9)

    @property
    def audio_s_per_s_per_chip(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9) / self.n_chips

    def as_dict(self) -> dict:
        return {"rtf": self.rtf, "audio_s_per_s_per_chip": self.audio_s_per_s_per_chip,
                "audio_seconds": self.audio_seconds, "wall_seconds": self.wall_seconds}


def spans_as_trace_events(snap: Snapshot, t_from: int, t_to: int, wall_minus_perf: int, base_ns: int,
                          pid: int) -> list:
    """The snapshot's spans that overlap [t_from, t_to] (`perf_counter_ns`)
    as Chrome trace events ("X", microseconds after `base_ns` on
    `time.time_ns()`'s clock), one row a thread; a span still open ends at
    `t_to`."""
    sp = snap.spans
    out = []
    for k in range(len(sp["seq"])):
        t0, t1 = int(sp["t0"][k]), int(sp["t1"][k]) or t_to
        if t1 < t_from or t0 > t_to:
            continue
        out.append({"ph": "X", "cat": "program", "name": snap.names[sp["name"][k]], "pid": pid,
                    "tid": int(sp["thread"][k]), "ts": (t0 + wall_minus_perf - base_ns) / 1e3,
                    "dur": (t1 - t0) / 1e3,
                    "args": {"seq": int(sp["seq"][k]), "parent": int(sp["parent"][k]), "rid": int(sp["rid"][k]),
                             "attr": [int(a) for a in sp["attr"][k]]}})
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler trace (CPU, and CUDA where a card is present) of the
    block, written as a Chrome trace `{log_dir}/trace.json` (chrome://tracing
    or Perfetto) when the block ends, with the recorder's spans of every
    thread over the block beside the profiler's events, on its clock.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # one pair of readings maps perf_counter_ns onto time.time_ns's clock
    wall, perf = time.time_ns(), time.perf_counter_ns()
    with profile(activities=activities) as prof:
        t_from = time.perf_counter_ns()
        yield prof
        t_to = time.perf_counter_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds")  # the file's timestamps are microseconds after it
    if base is None:
        raise RuntimeError(f"{path}: the profiler wrote no baseTimeNanoseconds; the spans cannot be placed")
    events = trace.setdefault("traceEvents", [])
    events.extend(spans_as_trace_events(_RECORDER.snapshot(), t_from, t_to, wall - perf, int(base), os.getpid()))
    with open(path, "w") as f:
        json.dump(trace, f)
