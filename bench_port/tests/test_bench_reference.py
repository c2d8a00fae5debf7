"""The plain reference (bench_port/reference/) against the port's modules,
at small widths on the CPU, both sides filled from one seed by the
benchmark's weight streams."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import traffic
from bench_port.reference import common, dit, eres2net, hubert, mel, precision, sola, t2s, v3, vits, voice
from bench_port.tests import tiny
from bench_port.weights import fill

SEED = 4242
TOL = 1e-5


def close(a, b, tol=TOL):
    a, b = torch.as_tensor(a).detach().double(), torch.as_tensor(b).detach().double()
    assert a.shape == b.shape
    assert float((a - b).norm() / b.norm().clamp_min(1e-30)) < tol


def pair(ref_mod, port_mod, stream):
    fill(ref_mod, SEED, stream)
    fill(port_mod, SEED, stream)
    return ref_mod.eval(), port_mod.eval()


@pytest.fixture(scope="module")
def v2cfg():
    return tiny.config("v2ProPlus")


@pytest.fixture(scope="module")
def v4cfg():
    return tiny.config("v4")


def test_weights_fill_same_names_same_values(v2cfg):
    from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
    from gpt_sovits_tpu_torch.utils.config import S1Config

    a, b = pair(t2s.T2SDecoder(common.make(common.S1Config, v2cfg["s1"])),
                T2SDecoder(common.make(S1Config, v2cfg["s1"])), "s1")
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert float(pa["h.layers.0.norm1.weight"].detach().min()) == 1.0
    fill(a, SEED + 1, "s1")
    assert not torch.equal(dict(a.named_parameters())["ar_predict_layer.weight"], pb["ar_predict_layer.weight"])


def test_s1_logits_match_the_port_forward(v2cfg):
    from gpt_sovits_tpu_torch.models.t2s import T2SDecoder, build_prefix_attn_bias
    from gpt_sovits_tpu_torch.utils.config import S1Config

    ref, port = pair(t2s.T2SDecoder(common.make(common.S1Config, v2cfg["s1"])),
                     T2SDecoder(common.make(S1Config, v2cfg["s1"])), "s1")
    g = torch.Generator().manual_seed(1)
    phones = torch.randint(0, 700, (23,), generator=g)
    sem = torch.randint(0, 1024, (40,), generator=g)
    got = ref.logits(phones, sem)
    tx, ty = len(phones), len(sem)
    xe = port.embed_text(phones[None], torch.zeros(1, tx, 1024), torch.arange(tx)[None])
    ye = port.embed_audio(sem[None], torch.arange(ty)[None])
    bias = build_prefix_attn_bias(torch.ones(1, tx, dtype=torch.bool), torch.ones(1, ty, dtype=torch.bool))
    want = port(torch.cat([xe, ye], 1), bias)[0, tx:]
    close(got, want)


def test_s1_logits_follow_the_port_decode(v2cfg):
    """The reference's rows are what the port's prefill and cached steps give
    for the same tokens (its plain step, greedy without penalty)."""
    from gpt_sovits_tpu_torch.models.t2s import T2SDecoder, generate
    from gpt_sovits_tpu_torch.utils.config import S1Config

    ref, port = pair(t2s.T2SDecoder(common.make(common.S1Config, v2cfg["s1"])),
                     T2SDecoder(common.make(S1Config, v2cfg["s1"])), "s1")
    g = torch.Generator().manual_seed(2)
    phones = torch.randint(0, 700, (17,), generator=g)
    prompt = torch.randint(0, 1024, (30,), generator=g)
    out = generate(port, phones[None], torch.tensor([17]), torch.zeros(1, 17, 1024), prompt[None],
                   torch.tensor([30]), max_new_tokens=12, top_k=1, repetition_penalty=1.0)
    served = out.tokens[0, : int(out.lengths[0])]
    logits = ref.logits(phones, torch.cat([prompt, served]))[-(len(served) + 1):]
    gaps = voice.greedy_gaps(logits, prompt, served, penalty=1.0, eos=1024, capped=True)
    assert float(gaps.max()) < 1e-4


def test_hubert_and_speaker_embedding_match(v2cfg):
    from gpt_sovits_tpu_torch.models import eres2net as pe
    from gpt_sovits_tpu_torch.models import hubert as ph

    rh, ph_ = pair(hubert.HubertEncoder(common.make(hubert.HubertConfig, v2cfg["hubert"])),
                   ph.HubertEncoder(common.make(ph.HubertConfig, v2cfg["hubert"])), "hubert")
    wav = torch.from_numpy(traffic.reference_wav(3, 16000, 3.0))[None]
    close(rh(wav), ph_(wav))
    rs, ps = pair(eres2net.ERes2NetV2(common.make(eres2net.ERes2NetConfig, v2cfg["sv"])),
                  pe.ERes2NetV2(common.make(pe.ERes2NetConfig, v2cfg["sv"])), "sv")
    close(eres2net.kaldi_fbank(wav), pe.kaldi_fbank(wav))
    close(rs(eres2net.kaldi_fbank(wav)), ps(pe.kaldi_fbank(wav)))


def test_s2_decode_and_generator_match(v2cfg):
    from gpt_sovits_tpu_torch.dsp import mel as pm
    from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
    from gpt_sovits_tpu_torch.utils.config import MelConfig, S2Config

    ref, port = pair(vits.SynthesizerTrn(common.make(common.S2Config, v2cfg["s2"])),
                     SynthesizerTrn(common.make(S2Config, v2cfg["s2"])), "s2")
    wav = torch.from_numpy(traffic.reference_wav(5, 32000, 3.0))[None]
    spec_r = mel.spectrogram(wav, common.make(common.MelConfig, v2cfg["mel"]))[0].T[None]
    spec_p = pm.spectrogram(wav, common.make(MelConfig, v2cfg["mel"]))[0].T[None]
    close(spec_r, spec_p)
    g = torch.Generator().manual_seed(3)
    codes = torch.randint(0, 1024, (1, 37), generator=g)
    text = torch.randint(0, 700, (1, 21), generator=g)
    sv = torch.randn(1, v2cfg["s2"]["sv_dim"], generator=g) * 0.1
    args = (codes, torch.tensor([37]), text, torch.tensor([21]), spec_r, torch.tensor([spec_r.shape[1]]))
    zr, ger = ref.decode_latent(*args, sv_emb=sv)
    zp, gep = port.decode_latent(*args, sv_emb=sv)
    close(zr, zp)
    close(ref.dec(zr, g=ger), port.dec(zp, g=gep))
    ssl = torch.randn(1, 40, v2cfg["s2"]["ssl_dim"], generator=g)
    assert torch.equal(ref.extract_latent(ssl), port.extract_latent(ssl))


def test_v4_encp_cfm_and_vocoder_match(v4cfg):
    from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3, cfm_inference
    from gpt_sovits_tpu_torch.models.vits import Generator
    from gpt_sovits_tpu_torch.utils.config import S2Config

    ref, port = pair(v3.SynthesizerTrnV3(common.make(common.S2Config, v4cfg["s2"])),
                     SynthesizerTrnV3(common.make(S2Config, v4cfg["s2"])), "s2")
    g = torch.Generator().manual_seed(4)
    codes = torch.randint(0, 1024, (1, 25), generator=g)
    text = torch.randint(0, 700, (1, 19), generator=g)
    spec = torch.rand(1, 60, 1025, generator=g)
    args = (codes, torch.tensor([25]), text, torch.tensor([19]), spec, torch.tensor([60]))
    fr, ger, lr = ref.decode_encp(*args)
    fp, gep, lp = port.decode_encp(*args)
    close(fr, fp)
    assert torch.equal(lr, lp)
    mu = torch.randn(2, 96, 512, generator=g) * 0.3
    prompt = torch.randn(2, 30, 100, generator=g) * 0.3
    noise = torch.randn(2, 96, 100, generator=g)
    lens = torch.tensor([96, 96])
    close(v3.cfm_inference(ref.cfm.estimator, mu, lens, prompt, noise=noise, n_steps=3),
          cfm_inference(port.cfm.estimator, mu, lens, prompt, noise=noise, n_steps=3))
    voc = v4cfg["vocoder"]
    rv, pv = pair(vits.Generator(common.make(common.S2Config, voc), in_channels=100, use_post_bias=True,
                                 conditioned=False),
                  Generator(common.make(S2Config, voc), in_channels=100, use_post_bias=True, conditioned=False),
                  "vocoder")
    m = torch.randn(1, 20, 100, generator=g)
    close(rv(m), pv(m))


def test_chunk_plan_assembly_mel_and_sola_match():
    from gpt_sovits_tpu_torch.dsp import mel as pm
    from gpt_sovits_tpu_torch.dsp.sola import sola_stitch
    from gpt_sovits_tpu_torch.infer.pipeline import _v3_assemble_chunks, v3_chunk_plan
    from gpt_sovits_tpu_torch.utils.config import MEL_V4

    for total in (1, 523, 524, 525, 1500, 4096, 9000):
        assert voice.chunk_plan(total, 524, 12) == v3_chunk_plan(total, 524, 12)
    g = torch.Generator().manual_seed(5)
    feats, ref0 = torch.randn(1, 1500, 8, generator=g), torch.randn(1, 500, 8, generator=g)
    bs, _, bucket = voice.chunk_plan(1500, 524, 12)
    want = _v3_assemble_chunks(feats, ref0, bs=bs, bs_pad=bucket, overlap=12, chunk_len=524)[:bs]
    assert torch.equal(voice.assemble_chunks(feats, ref0, bs=bs, overlap=12, chunk_len=524), want)
    wav = torch.from_numpy(traffic.reference_wav(6, 32000, 2.0))[None]
    cfg = tiny.config("v4")["cfm_mel"]
    close(mel.mel_spectrogram(wav, common.make(common.MelConfig, cfg)), pm.mel_spectrogram(wav, MEL_V4))
    rng = np.random.default_rng(0)
    frags = [rng.standard_normal(3000).astype(np.float32) for _ in range(3)]
    assert np.array_equal(sola.sola_stitch(frags, 480), sola_stitch(frags, 480))


def test_gaps_read_a_wrong_token_and_an_early_stop():
    g = torch.Generator().manual_seed(7)
    logits = torch.randn(6, 50, generator=g)
    prompt = torch.tensor([3, 4])
    pen = voice.penalized(logits, voice.presence_rows(prompt, torch.zeros(0, dtype=torch.long), 50, 49)[:1], 1.35, 49)
    best = int(pen[0].argmax())
    served = torch.tensor([best])
    assert float(voice.greedy_gaps(logits[:2], prompt, served, penalty=1.35, eos=49, capped=True).max()) == 0.0
    worst = int(pen[0].argmin())
    assert float(voice.greedy_gaps(logits[:2], prompt, torch.tensor([worst]), penalty=1.35, eos=49,
                                   capped=True).max()) > 1.0
    # a row that stops before its cap and before EOS may end it
    assert voice.greedy_gaps(logits[:2], prompt, served, penalty=1.35, eos=49, capped=False)[-1] == float("inf")


def test_control_rounds_to_lower_precision():
    x = torch.randn(8, 64)
    q4 = precision.fake_quant(x, 4, dim=1)
    assert len(torch.unique(q4[0])) <= 15
    e = float((precision.fp8(x) - x).norm() / x.norm())
    assert 1e-3 < e < 0.1
    d = dit.DiT(dit.DiTConfig(dim=128, depth=1, heads=2))
    fill(d, SEED, "dit")
    args = (torch.randn(1, 8, 100), torch.randn(1, 8, 100), torch.rand(1), torch.rand(1), torch.randn(1, 8, 512))
    before = d(*args)[0]
    w = d.transformer_blocks[0].attn.to_q.weight.clone()
    dit.lower_precision(d, 4)
    assert not torch.equal(w, d.transformer_blocks[0].attn.to_q.weight)
    assert 0 < float((d(*args)[0] - before).norm() / before.norm()) < 1
