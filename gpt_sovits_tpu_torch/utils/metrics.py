"""Metrics logging, phase timing, throughput counters and a profiler
hook (port of gpt_sovits_tpu/utils/metrics.py: MetricsLogger, PhaseTimer,
ThroughputMeter; `profile_trace` on torch.profiler where the JAX package
uses jax.profiler)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass

import torch


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
    """Named phase timing (the reference's hand-rolled t0..t5 lines)."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.phases.values())
        parts = [f"{k}:{v:.3f}s" for k, v in self.phases.items()]
        return f"{' '.join(parts)} total:{total:.3f}s"


@dataclass
class ThroughputMeter:
    """Audio seconds synthesized against wall seconds, over requests, and
    per chip (`n_chips`)."""

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


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler trace (CPU, and CUDA where a card is present) of the
    block, written as a Chrome trace `{log_dir}/trace.json` (chrome://tracing
    or Perfetto) when the block ends. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
