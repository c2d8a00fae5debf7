"""Readings from which a cell's limits of `correct` are set, on the card:

    python3 -m bench_port.calibrate --workload <cell> --seeds 1,2,... --control 3 --seconds 10

In one process, for each seed: one run of the cell (set-up, a short window
at the cell's own load, the sample) and the numbers its check compares,
against the plain reference; for the first `--control` seeds also the
control's numbers on the same sample (the reference one precision step
below the configuration's, bench_port/reference/voice.py). One JSON line a
seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from bench_port import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="control readings on this many of the seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import importlib

    import torch

    torch.set_num_threads(1)  # as bench_port/run.py
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    cell = bench_run.Cell(json.loads(Path("BENCHMARK.json").read_text()), args.workload)
    family = importlib.import_module(f"bench_port.families.{cell.cfg['family']}")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        result, run = bench_run.measure(cell, seed, args.seconds, False)
        line = {"seed": seed, "program": {k: v["value"] for k, v in result["checks"].items()},
                "checked": result["checked"], "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        if i < args.control:
            numbers = family.check(cell.cfg, seed, "cuda", bench_run.draw_sample(run), run.sentences, control=True)
            numbers.pop("_checked", None)
            line["control"] = {k: bench_run.finite(v) for k, v in numbers.items()}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
