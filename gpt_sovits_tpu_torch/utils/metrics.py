"""Metrics logging, phase timing and throughput counters (a copy of
gpt_sovits_tpu/utils/metrics.py's MetricsLogger, PhaseTimer and
ThroughputMeter parts that the trainers and `TTSPipeline.run` use)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass


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
    """Audio seconds synthesized against wall seconds, over requests."""

    audio_seconds: float = 0.0
    wall_seconds: float = 0.0

    def measure_done(self, audio_seconds: float, wall_seconds: float) -> None:
        """Record an already-timed request (phases measured elsewhere)."""
        self.audio_seconds += audio_seconds
        self.wall_seconds += wall_seconds

    @property
    def rtf(self) -> float:
        return self.wall_seconds / max(self.audio_seconds, 1e-9)
