"""What the benchmark's command and its reference load: never JAX, jaxlib,
flax or the JAX package (compared by whole top-level names: the port's name
begins with the JAX package's), nothing of the port in the reference, and
nothing read from benchmarks/."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_port"
FORBIDDEN = {"jax", "jaxlib", "flax", "gpt_sovits_tpu"}


def imported_tops(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def string_constants(path: Path) -> list:
    """The source's string literals, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_sources_import_no_jax_and_the_reference_nothing_of_the_port():
    for path in BENCH.rglob("*.py"):
        tops = imported_tops(path)
        assert not tops & (FORBIDDEN | {"benchmarks"}), (path, tops)
        if "reference" in path.relative_to(BENCH).parts:
            assert "gpt_sovits_tpu_torch" not in tops, path
        if path != Path(__file__).resolve():
            assert not any("benchmarks" in s for s in string_constants(path)), path
    for path in BENCH.rglob("*.json"):
        assert "benchmarks/" not in path.read_text(), path


def test_runs_and_the_reference_load_no_jax(tmp_path):
    """A whole (small, CPU) run of each cell, then the reference alone in a
    process of its own: the modules each process holds at its end."""
    run_code = (
        "import json, sys, torch; torch.set_num_threads(2)\n"
        "from bench_port.tests import tiny\n"
        "from bench_port import run\n"
        "v2 = tiny.cell('v2pp.serve.c16', clients=2)\n"
        "v4 = tiny.cell('v4.batch.para', shapes=[{'segments': 2, 'max_sec': 1}])\n"
        "for c in (v2, v4):\n"
        "    run.measure(c, 11, 1.0, False, device='cpu')\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    ref_code = (
        "import json, sys\n"
        "from bench_port.reference import voice\n"
        "from bench_port.tests.tiny import config\n"
        "from bench_port import traffic\n"
        "r = voice.VoiceReference(config('v4'), 3, 'cpu')\n"
        "p = r.prompt(traffic.reference_wav(3, 32000, 4.0), 32000, [1, 2, 3, 4, 5, 6, 7])\n"
        "r.s1_logits([5, 6, 7], p['codes'], [1, 2, 3])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    for code, port_allowed in ((run_code, True), (ref_code, False)):
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        found = json.loads(out.stdout.strip().splitlines()[-1])
        if port_allowed:
            assert found == []
        else:
            assert not set(found) & (FORBIDDEN | {"gpt_sovits_tpu_torch"}), found
