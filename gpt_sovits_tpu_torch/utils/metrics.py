"""Phase timing and throughput counters (a copy of the parts of
gpt_sovits_tpu/utils/metrics.py that `TTSPipeline.run` uses)."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass


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
