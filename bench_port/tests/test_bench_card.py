"""On the card, at each cell's own size: a short run of the cell is correct,
and the control (the reference one precision step below the configuration,
put in the program's place) fails at least one of the cell's numbers. The
readings the limits were set from are `python3 -m bench_port.calibrate`'s
(PERF.md); this keeps the control's failure checked at one seed a cell."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import pytest

from bench_port import run as bench_run

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("name,seconds", [("v2pp.serve.c16", 8.0), ("v4.batch.para", 12.0)])
def test_control_fails_where_the_program_passes(card, name, seconds):
    cell = bench_run.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), name)
    result, run = bench_run.measure(cell, 2**31 + 5, seconds, False)
    assert result["correct"], result["checks"]
    family = importlib.import_module(f"bench_port.families.{cell.cfg['family']}")
    numbers = family.check(cell.cfg, run.seed, "cuda", bench_run.draw_sample(run), run.sentences, control=True)
    numbers.pop("_checked")
    limits = cell.spec["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
