"""broken_copies.py on the CPU: each planted fault names a line that occurs
exactly once in its source (so the copy breaks what it says it breaks), and
each of its checks is one that the script runs."""

import ast
from pathlib import Path

import pytest

import broken_copies

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("copy", broken_copies.COPIES, ids=[c[0] for c in broken_copies.COPIES])
def test_copy_line_occurs_once(copy):
    name, src, old, new, checks = copy
    text = (ROOT / src).read_text()
    assert text.count(old) == 1, f"{name}: {old!r} occurs {text.count(old)} times in {src}"
    assert old != new
    assert checks and all(c in broken_copies.CHECKS for c in checks)


def test_every_check_is_a_chip_smoke_call():
    """Each CHECKS entry parses and calls a function chip_smoke defines."""
    import chip_smoke

    for name, expr in broken_copies.CHECKS.items():
        call = ast.parse(expr, mode="eval").body
        assert isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute), name
        assert call.func.value.id == "c" and callable(getattr(chip_smoke, call.func.attr)), name


def test_every_check_is_used():
    used = {c for copy in broken_copies.COPIES for c in copy[4]}
    assert used == set(broken_copies.CHECKS)
