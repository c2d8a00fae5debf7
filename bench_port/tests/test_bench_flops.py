"""The yardstick's counts (bench_port/flops/) against counts worked out by
hand and against multiply-accumulates counted on the reference's own
modules, and the metrics built on them at made-up timings that equal the
bound."""

from __future__ import annotations

import types

import pytest
import torch

from bench_port.flops import dit, peaks, s1, vits
from bench_port.reference import common
from bench_port.reference import dit as rdit
from bench_port.reference import t2s as rt2s
from bench_port.reference import vits as rvits
from bench_port.tests import tiny
from bench_port.weights import fill

S1_TINY = {"num_layers": 2, "hidden_dim": 4, "ffn_dim": 8, "vocab_size": 10}


class MacCounter:
    """Multiply-accumulates of every Linear, Conv1d and ConvTranspose1d call
    (and S1's fused q||k||v projection) under the block."""

    def __init__(self, module):
        self.macs, self.handles = 0, []
        for m in module.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.ConvTranspose1d, rt2s.SelfAttention)):
                self.handles.append(m.register_forward_hook(self.hook))

    def hook(self, m, args, out):
        x = args[0]
        if isinstance(m, rt2s.SelfAttention):
            self.macs += x.shape[:-1].numel() * m.in_proj_weight.numel()
        elif isinstance(m, torch.nn.Linear):
            self.macs += x.shape[:-1].numel() * m.weight.numel()
        elif isinstance(m, torch.nn.Conv1d):
            self.macs += out.shape[0] * out.shape[2] * m.weight.numel()
        else:
            self.macs += x.shape[0] * x.shape[2] * m.weight.numel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def test_s1_counts_by_hand():
    assert s1.layer_macs(S1_TINY) == 3 * 16 + 16 + 2 * 4 * 8
    ops, nbytes = s1.decode_step(S1_TINY, [3, 5])
    assert ops == (2 * 2 * 128 + 4 * 2 * 4 * 4) + (2 * 2 * 128 + 4 * 2 * 4 * 6)
    weights = 2 * 128 + 2 * (12 + 4 + 8 + 4) * 4 + 2 * (12 + 4 + 16 + 8 + 4) * 4
    kv = 2 * 3 * 16 + 2 * 5 * 16 + 2 * 2 * 16
    assert nbytes == weights + kv + 2 * 4 * 4 * 2
    assert s1.prefill(S1_TINY, 2, 3) == 2 * 2 * 128 * 5 + 4 * 2 * 4 * (4 + 6 + 6)
    assert s1.decode_ops(S1_TINY, 3, 10) == sum(2 * 2 * 128 + 4 * 2 * 4 * (10 + j + 1) for j in range(3))
    assert s1.head(S1_TINY) == 2 * 4 * 10


def test_s1_layer_macs_as_the_reference_runs_them():
    c = tiny.config("v2ProPlus")["s1"]
    model = rt2s.T2SDecoder(common.make(common.S1Config, c))
    fill(model, 1, "s1")
    with MacCounter(model.h) as mc:
        model.logits(torch.arange(7), torch.arange(9))
    assert mc.macs == c["num_layers"] * s1.layer_macs(c) * 16


def test_prompt_tokens_follow_the_conv_stack():
    h = tiny.config("v2ProPlus")["hubert"]
    assert s1.prompt_tokens(h, 5 * 16000 + 4800) == 132


def test_dit_block_by_hand_and_on_the_reference():
    c = {"cfm_dit_dim": 128, "cfm_dit_heads": 2, "cfm_dit_depth": 1, "cfm_mel_channels": 100}
    macs = 3 * 128 * 128 + 128 * 128 + 128 * 256 + 256 * 128
    assert dit.block_macs(c) == macs
    ops, nbytes = dit.block(c, 2, 3)
    assert ops == 2 * (2 * 3 * macs + 4 * 9 * 128)
    assert nbytes == macs + (3 * 128 + 128 + 256 + 128) * 8 + 2 * 3 * 128 * 4
    blk = rdit.DiTBlock(rdit.DiTConfig(dim=128, depth=1, heads=2))
    fill(blk, 2, "dit")
    with MacCounter(blk) as mc:
        blk(torch.randn(2, 3, 128), torch.randn(2, 128), None)
    assert mc.macs == 2 * 3 * macs + 2 * 6 * 128 * 128  # the six matmuls, and AdaLN's linear once a row


def test_generator_counts_as_the_reference_runs_it():
    for name, in_ch, kw in (("v2ProPlus", None, {}), ("v4", 100, {"use_post_bias": True})):
        cfg = tiny.config(name)
        c = cfg["s2"] if name == "v2ProPlus" else cfg["vocoder"]
        gen = rvits.Generator(common.make(common.S2Config, c), in_channels=in_ch, conditioned=False, **kw)
        fill(gen, 3, "vocoder")
        frames = 7
        with MacCounter(gen) as mc:
            gen(torch.randn(1, frames, in_ch or c["inter_channels"]))
        assert 2 * mc.macs == vits.generator(c, frames, in_ch or c["inter_channels"])


def test_s2_counts_stay_below_what_the_reference_runs():
    """The text encoder and the flow leave out normalisation, the
    relative-position terms and the conditioning on ge: a lower bound of the
    convolutions and matmuls the reference runs, within 10% of it."""
    cfg = tiny.config("v2ProPlus")
    c = cfg["s2"]
    model = rvits.SynthesizerTrn(common.make(common.S2Config, c))
    fill(model, 4, "s2")
    n, m = 20, 11
    spec = torch.rand(1, 30, 1025)
    with MacCounter(model.enc_p) as enc, MacCounter(model.flow) as fl:
        model.decode_latent(torch.randint(0, 1024, (1, n)), torch.tensor([n]), torch.randint(0, 700, (1, m)),
                            torch.tensor([m]), spec, torch.tensor([30]), sv_emb=torch.zeros(1, c["sv_dim"]))
    counted = vits.s2_decode(c, n, m) / 2
    t, h, w, layers = 2 * n, c["hidden_channels"], c["mrte_hidden"], c["n_layers"]
    attention = 2 * h * (layers * t * t + layers * m * m) + 2 * t * m * w  # the scores and values, not modules
    ran = enc.macs + fl.macs + attention - 4 * c["gin_channels"] * 2 * h * 4  # less the flows' cond layers
    assert 0.9 * ran <= counted <= ran


def _fake_run(cfg, **kw):
    run = types.SimpleNamespace(cfg=cfg, **kw)
    return run


def test_rooflines_and_mfu_reach_100_at_the_bound(monkeypatch):
    from bench_port import pool
    from bench_port.run import load_metric
    from bench_port.traffic import load as sentences

    cfg = tiny.config("v2ProPlus")
    sents = sentences("sentences_en")
    scratch = cfg["serving"]["tx_max"] + cfg["serving"]["tp_max"]
    calls = [(0.1 * i, [scratch + i] * 4 + [scratch] * 4) for i in range(1, 20)]
    run = _fake_run(cfg, k1_calls=calls, sentences=sents)
    least = pool.k1_least_s(run, 0.0, 10.0)
    reading = types.SimpleNamespace(matched=True, t0=0.0, t1=10.0, window_s=1.0, busy_s=0.25,
                                    kernel_s=lambda pattern: least)
    run.reading = reading
    assert load_metric("k1_roofline").read(run) == pytest.approx(100.0)
    assert load_metric("device_idle").read(run) == pytest.approx(75.0)

    cfg4 = tiny.config("v4")
    rec = {"cfm_batch": [(3, 4), (5, 6)]}
    c, cfm = cfg4["s2"], cfg4["cfm"]
    least4 = sum(cfm["sample_steps"] * c["cfm_dit_depth"] * peaks.bound_s(*dit.block(c, bs, cfm["t_chunk"]), "int8")
                 for bs, _ in rec["cfm_batch"])
    run4 = _fake_run(cfg4, traced=rec, reading=types.SimpleNamespace(matched=True, kernel_s=lambda p: least4))
    assert load_metric("dit_int8_roofline").read(run4) == pytest.approx(100.0)

    done = [{"req": {"sentences": [0, 1]}, "tokens": [[0] * 40, [0] * 40]}]
    mfu = load_metric("mfu")
    run2 = _fake_run(cfg, done=done, sentences=sents, window_s=1.0)
    busy = mfu.read(run2) / 100.0  # the seconds the work needs at the peaks
    run2.window_s = busy
    assert mfu.read(run2) == pytest.approx(100.0)
