"""The traffic generator is a function of the seed, and the harness finds
configurations, cells, mixes and metrics by name, with no code edited."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from bench_port import traffic

ROOT = Path(__file__).resolve().parents[2]
MIXES = ("serve_c16_en", "para_en")


def draws(mix: str, seed: int, n: int = 40) -> list:
    seq = traffic.Requests(traffic.load(mix), seed)
    return [seq.next() for _ in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    big = 2**31 + 12345  # a seed may run past 32 bits
    assert draws(mix, big) == draws(mix, big)
    a, b = draws(mix, big), draws(mix, big + 1)
    for key in ("text", "sentences", "seed", "sampling"):
        assert [r[key] for r in a] != [r[key] for r in b], key
    assert [(len(r["sentences"]), r["max_sec"]) for r in a] != [(len(r["sentences"]), r["max_sec"]) for r in b]


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_sends_the_same_sizes(mix):
    m = traffic.load(mix)
    cycle = sum(m["shapes"]["counts"])
    want = Counter({(v["segments"], v.get("max_sec")): c for v, c in zip(m["shapes"]["values"], m["shapes"]["counts"])})
    for seed in (1, 2, 3):
        assert Counter((len(r["sentences"]), r["max_sec"]) for r in draws(mix, seed, cycle)) == want
        sampling = Counter(json.dumps(r["sampling"], sort_keys=True) for r in draws(mix, seed, 4 * len(m["sampling"])))
        assert set(sampling.values()) == {4}


def test_reference_clip_follows_the_seed():
    a = traffic.reference_wav(2**31 + 7, 32000, 5.0)
    assert np.array_equal(a, traffic.reference_wav(2**31 + 7, 32000, 5.0))
    assert not np.array_equal(a, traffic.reference_wav(2**31 + 8, 32000, 5.0))
    assert a.shape == (160000,) and np.abs(a).max() < 1.0


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a cell and a metric dropped into a copy of
    bench_port/ are found by the names BENCHMARK.json gives them."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench_port/configs/v2ProPlus.json").read_text())
    cfg["name"] = "v2ProPlus_b"
    (tmp_path / "bench_port/configs/v2ProPlus_b.json").write_text(json.dumps(cfg))
    mix = traffic.load("serve_c16_en")
    mix["clients"] = 4
    (tmp_path / "bench_port/traffic/serve_c4_en.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "bench_port/workloads/v2pp.serve.c16.json").read_text())
    (tmp_path / "bench_port/workloads/v2ppb.serve.c4.json").write_text(json.dumps(spec))
    (tmp_path / "bench_port/metrics/answer_ms.py").write_text('def read(run):\n    return 42.0\n')
    bench["configs"].append({"name": "v2ProPlus_b", "source": "x", "file": "bench_port/configs/v2ProPlus_b.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "v2ppb.serve.c4", "config": "v2ProPlus_b", "traffic": "serve_c4_en",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "answer_ms", "unit": "ms", "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "audio_s_per_s", "workloads": ["v2ppb.serve.c4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from bench_port import run; "
            "c = run.Cell(json.load(open('BENCHMARK.json')), 'v2ppb.serve.c4'); "
            "print(json.dumps([c.cfg['name'], c.mix['clients'], [m['name'] for m in c.per_layer], "
            "run.load_metric('answer_ms').read(None), run.HERE.parent == __import__('pathlib').Path.cwd()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    name, clients, per_layer, answer, here = json.loads(out.stdout.strip().splitlines()[-1])
    assert (name, clients, answer, here) == ("v2ProPlus_b", 4, 42.0, True)
    assert "answer_ms" in per_layer and "device_idle" not in per_layer
