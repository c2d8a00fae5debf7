"""The general traffic generator: a traffic mix is a data file,
`traffic/<name>.json`, of parameters that this module turns into requests
from the run's seed.

Parameters of a mix:
  driver      the entry point the requests go through (`drivers/<driver>.py`)
  clients     closed-loop callers: each sends its next request when the
              previous one has returned
  language    the language mode the requests are sent with
  sentences   the sentence list (`traffic/<sentences>.json`); every sentence
              is one segment of the cut method
  shapes      {"values": [...], "counts": [...]}: a request's shape, its
              `segments` and, where S1's cap is set a request, `max_sec`
  sampling    a list of sampling settings (top_k, top_p, temperature)

Shapes and sampling settings are dealt in cycles: a cycle holds every value
as many times as its count, in an order drawn from the seed, so every seed
sends the same set of sizes in another order, and the cells' work does not
change with the seed. Sentences and each request's own seed are drawn from
the seed too. The same seed gives the same sequence of requests.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from bench_port.weights import stream_seed

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _deck(spec, rng: np.random.Generator):
    """Endless values of a {"values", "counts"} spec (or a list: each
    value once), a shuffled cycle at a time."""
    if isinstance(spec, list):
        spec = {"values": spec, "counts": [1] * len(spec)}
    cycle = [v for v, c in zip(spec["values"], spec["counts"]) for _ in range(int(c))]
    while True:
        for i in rng.permutation(len(cycle)):
            yield cycle[i]


class Requests:
    """The seeded sequence of requests of one mix (not for several threads
    at once)."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.lists = load(mix["sentences"])
        rng = np.random.default_rng(stream_seed(seed, "traffic"))
        self._rng = rng
        self._shapes = _deck(mix["shapes"], rng)
        self._sampling = _deck(list(range(len(mix["sampling"]))), rng)

    def next(self) -> dict:
        """{"text", "sentences" (ids), "sampling", "max_sec", "seed"}."""
        shape = next(self._shapes)
        ids = [int(i) for i in self._rng.integers(len(self.lists["sentences"]), size=int(shape["segments"]))]
        req = {
            "text": " ".join(self.lists["sentences"][i]["text"] for i in ids),
            "sentences": ids,
            "sampling": dict(self.mix["sampling"][next(self._sampling)]),
            "max_sec": shape.get("max_sec"),
            "seed": int(self._rng.integers(2**31 - 1)),
        }
        return req


def reference_wav(seed: int, sr: int, sec: float) -> np.ndarray:
    """A voiced, pitch-gliding reference clip with a little noise, from the
    seed (as chip_smoke.py's reference_wav makes its clip)."""
    rng = np.random.default_rng(stream_seed(seed, "reference_wav"))
    t = np.arange(int(sr * sec)) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / sr) / k for k in range(1, 8))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t) ** 2
    return (0.2 * voiced * env + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
