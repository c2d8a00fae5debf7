"""The PyTorch port, chip_smoke.py and broken_copies.py stand alone: they
import with jax, flax and transformers blocked, and no file of theirs
imports jax, flax, transformers or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gpt_sovits_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "broken_copies.py"]
BANNED = ("jax", "jaxlib", "flax", "transformers", "gpt_sovits_tpu")

_BLOCKER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
import importlib, pkgutil
import gpt_sovits_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(gpt_sovits_tpu_torch.__path__, "gpt_sovits_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke, broken_copies
assert not any(k.split(".")[0] in {banned!r} for k in sys.modules), [k for k in sys.modules if k.startswith(("jax", "flax", "transformers"))]
print("OK", len(mods), " ".join(mods))
"""


def test_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    code = _BLOCKER.format(banned=set(BANNED))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")
    assert int(res.stdout.split()[1]) >= 41  # every module of the five slices was imported
    for mod in ("models.dit", "models.v3", "ops.qmatmul", "ops.qflash", "dsp.sola", "models.bigvgan", "models.apbwe",
                "ops.snake_aa", "infer.continuous", "serve.continuous_service", "serve.api", "serve.gui_client",
                "models.bert", "text.bert_tokenizer", "text.zh_norm", "text.tone_sandhi", "text.chinese",
                "text.lang_segmenter", "text.japanese", "text.korean", "text.cantonese", "text.g2pw",
                "utils.onnx_lite"):
        assert f"gpt_sovits_tpu_torch.{mod}" in res.stdout, mod


def test_no_banned_imports_in_source():
    assert len(FILES) > 15
    for path in FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BANNED, f"{path}: imports {n}"
        assert "gpt_sovits_tpu." not in path.read_text(), f"{path} names the JAX package"
