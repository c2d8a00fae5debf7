"""A whole run of each cell, small and on the CPU (the look for a card
skipped), with the timed path broken underneath: a token or an answer
altered where it is produced must turn `correct` false; the unbroken run
must leave it true. The limits are the cells' own (workloads/*.json)."""

from __future__ import annotations

import pytest
import torch

from bench_port import run as bench_run
from bench_port.tests import tiny

SEED = 2**31 + 99


def small(name: str):
    if name == "v2pp.serve.c16":
        return tiny.cell(name, clients=3)
    c = tiny.cell(name, shapes=[{"segments": 2, "max_sec": 2}, {"segments": 3, "max_sec": 2}])
    c.mix["sampling"] = [{"top_k": 1}, {"top_k": 5, "temperature": 1.0}]
    c.spec = {**c.spec, "sample": {"greedy": 1, "any": 1}}
    return c


def measure(name: str) -> dict:
    torch.set_num_threads(2)
    result, _ = bench_run.measure(small(name), SEED, 2.0, False, device="cpu")
    return result


def altered_greedy(fn, greedy):
    """`fn` (a sampler) with every greedy row's token moved to the next id on
    every third call."""
    calls = [0]

    def wrapper(*args, **kw):
        tok = fn(*args, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0:
            rows = greedy(args, kw)
            tok = torch.where(rows, (tok + 1) % 1024, tok)
        return tok

    return wrapper


def scaled(fn, factor: float):
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, list):
            return [w * factor for w in out]
        if isinstance(out, tuple):
            return (out[0] * factor,) + tuple(out[1:])
        return out * factor

    return wrapper


@pytest.mark.parametrize("name", ["v2pp.serve.c16", "v4.batch.para"])
def test_sound_run_is_correct(name):
    result = measure(name)
    assert result["correct"], result["checks"]
    assert result["checked"]["greedy_tokens"] > 0


def test_pool_token_altered(monkeypatch):
    from gpt_sovits_tpu_torch.infer import continuous

    monkeypatch.setattr(continuous, "sample_token_rows", altered_greedy(
        continuous.sample_token_rows, lambda a, kw: a[2] == 1))
    result = measure("v2pp.serve.c16")
    assert not result["correct"] and result["checks"]["s1_gap"]["value"] > result["checks"]["s1_gap"]["limit"]


def test_s2_audio_altered(monkeypatch):
    from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline

    monkeypatch.setattr(TTSPipeline, "_s2_fetch", scaled(TTSPipeline._s2_fetch, 0.9))
    result = measure("v2pp.serve.c16")
    assert not result["correct"] and result["checks"]["wave_ratio"]["value"] > result["checks"]["wave_ratio"]["limit"]


def test_generate_token_altered(monkeypatch):
    from gpt_sovits_tpu_torch.models import t2s

    monkeypatch.setattr(t2s, "sample_token", altered_greedy(
        t2s.sample_token, lambda a, kw: torch.full_like(a[0][:, 0], kw["top_k"] == 1, dtype=torch.bool)))
    result = measure("v4.batch.para")
    assert not result["correct"] and result["checks"]["s1_gap"]["value"] > result["checks"]["s1_gap"]["limit"]


def test_cfm_mel_altered(monkeypatch):
    from gpt_sovits_tpu_torch.infer import pipeline

    monkeypatch.setattr(pipeline, "cfm_inference", scaled(pipeline.cfm_inference, 1.05))
    result = measure("v4.batch.para")
    assert not result["correct"] and result["checks"]["mel_err"]["value"] > result["checks"]["mel_err"]["limit"]


def test_vocoder_audio_altered(monkeypatch):
    from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline

    monkeypatch.setattr(TTSPipeline, "_v3_fetch", scaled(TTSPipeline._v3_fetch, 0.9))
    result = measure("v4.batch.para")
    assert not result["correct"] and result["checks"]["wave_ratio"]["value"] > result["checks"]["wave_ratio"]["limit"]
