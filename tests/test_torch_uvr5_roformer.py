"""The port's BS / Mel-Band RoFormer (gpt_sovits_tpu_torch/corpus/roformer.py)
against the JAX package's (gpt_sovits_tpu/corpus/roformer.py) on the CPU at
tiny widths, weights from a seed carried into JAX through its own importer
(`params_from_torch`): the chunk forward within 1e-5 (the JAX test holds
JAX to the reference within 3e-3), the weight round trip exact, the
fade-window demix and the whole `separate` on a checkpoint file with a
YAML config within 1e-5; the loader's handling of the fixed tables."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gpt_sovits_tpu.corpus import roformer as jr
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.corpus import roformer as pr

TOL = 1e-5
BS = dict(dim=32, depth=2, stereo=True, num_stems=1, time_transformer_depth=1, freq_transformer_depth=1,
          freqs_per_bands=(2, 2, 2, 2, 4, 4, 8, 8, 16, 17), dim_head=8, heads=2, stft_n_fft=128,
          stft_hop_length=32, stft_win_length=128, mask_estimator_depth=2)
MEL = dict(dim=32, depth=2, stereo=False, num_stems=1, time_transformer_depth=1, freq_transformer_depth=1,
           num_bands=12, dim_head=8, heads=2, sample_rate=16000, stft_n_fft=128, stft_hop_length=32,
           stft_win_length=128, mask_estimator_depth=2)
CASES = {"bs": BS, "mel": MEL, "mel_stereo_2stems": dict(MEL, stereo=True, num_stems=2),
         "bs_skip": dict(BS, skip_connection=True, depth=3)}


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def seeded(kw: dict, seed: int = 0) -> pr.Roformer:
    torch.manual_seed(seed)
    m = pr.Roformer(pr.RoformerConfig.from_dict(kw)).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn_like(p))  # norms' gammas off 1, biases off 0
    return m


def jax_params(m: pr.Roformer, kw: dict):
    return jr.params_from_torch({k: v.numpy() for k, v in m.state_dict().items()}, jr.RoformerConfig.from_dict(kw))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_equals_jax(case):
    kw = CASES[case]
    m = seeded(kw)
    assert m.cfg.kind == ("bs" if case.startswith("bs") else "mel")
    x = (0.3 * np.random.default_rng(1).standard_normal((2, m.cfg.audio_channels, 2048))).astype(np.float32)
    want = np.asarray(jr.Roformer(jr.RoformerConfig.from_dict(kw)).apply({"params": jax_params(m, kw)}, jnp.asarray(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, m.cfg.num_stems, m.cfg.audio_channels, 2048)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("case", ["bs", "mel"])
def test_weight_round_trip_through_the_jax_importer_is_exact(case):
    kw = CASES[case]
    m = seeded(kw)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    back = weights.roformer_from_jax(jax.tree.map(np.asarray, jax_params(m, kw)), m.cfg)
    assert set(back) == set(sd)
    for k in sd:
        assert np.array_equal(back[k].numpy(), sd[k]), k


def test_rotary_pairs_are_interleaved():
    x = torch.arange(8.0).reshape(1, 1, 8)
    assert pr.rotate_half_interleaved(x).flatten().tolist() == [-1.0, 0.0, -3.0, 2.0, -5.0, 4.0, -7.0, 6.0]
    q = torch.randn(1, 2, 5, 8)
    got = pr.apply_rotary(q)
    want = jr.apply_rotary(jnp.asarray(q.numpy()), 1.0 / (10000.0 ** (np.arange(0, 8, 2) / 8)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_demix_equals_jax():
    kw = MEL
    m = seeded(kw, seed=2)
    jm = jr.Roformer(jr.RoformerConfig.from_dict(kw))
    params = jax_params(m, kw)
    mix = (0.1 * np.random.default_rng(2).standard_normal((1, 5000))).astype(np.float32)
    jfn = jax.jit(lambda w: jm.apply({"params": params}, w))
    want = jr.demix(jfn, mix, chunk_size=1024, num_overlap=2, batch_size=2)
    got = pr.demix(m, mix, chunk_size=1024, num_overlap=2, batch_size=2)
    assert got.shape == want.shape == (1, 1, 5000)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("case", ["bs", "mel"])
def test_separate_on_a_checkpoint_file_equals_jax(case, tmp_path):
    kw = CASES[case]
    m = seeded(kw, seed=3)
    name = "model_bs_roformer_ep_1.ckpt" if case == "bs" else "mel_band_roformer_tiny.ckpt"
    sd = dict(m.state_dict())
    # the public files carry rotary_embedding_torch's frequency tables as parameters
    sd["layers.0.0.layers.0.0.rotary_embed.freqs"] = torch.ones(4)
    torch.save({"state_dict": sd}, tmp_path / name)
    cfg = tmp_path / "config.yaml"
    model_cfg = {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}
    cfg.write_text(yaml.safe_dump({"model": model_cfg, "audio": {"chunk_size": 2048, "sample_rate": 16000},
                                   "inference": {"batch_size": 2, "num_overlap": 2}}))
    rng = np.random.default_rng(4)
    wav = (0.2 * rng.standard_normal((2, 9000))).astype(np.float32)
    for sr in (16000, 8000):
        vj, oj = jr.separate(wav, sr, str(tmp_path / name), config_path=str(cfg))
        vp, op = pr.separate(wav, sr, str(tmp_path / name), config_path=str(cfg), device="cpu")
        assert vp.shape == vj.shape == (m.cfg.audio_channels, 9000) and op.shape == oj.shape
        np.testing.assert_allclose(vp, vj, atol=TOL)
        np.testing.assert_allclose(op, oj, atol=TOL)
    v1, o1 = pr.separate(wav[0], 16000, str(tmp_path / name), config_path=str(cfg), device="cpu")
    assert v1.shape == o1.shape == (9000,)


def test_loader_drops_only_the_fixed_tables():
    m = seeded(BS)
    sd = dict(m.state_dict())
    pr.load_roformer_state(pr.Roformer(m.cfg), {**sd, "layers.1.1.layers.0.0.rotary_embed.freqs": torch.ones(4)})
    with pytest.raises(RuntimeError):
        pr.load_roformer_state(pr.Roformer(m.cfg), {**sd, "layers.1.1.extra.weight": torch.ones(4)})
    del sd["final_norm.gamma"]
    with pytest.raises(RuntimeError):
        pr.load_roformer_state(pr.Roformer(m.cfg), sd)


def test_default_configs_match_jax():
    for d in ("DEFAULT_BS_MODEL", "DEFAULT_MEL_MODEL", "DEFAULT_BS_AUDIO", "DEFAULT_BS_INFER"):
        assert getattr(pr, d) == getattr(jr, d), d
    for kw in (pr.DEFAULT_BS_MODEL, pr.DEFAULT_MEL_MODEL):
        p, j = pr.RoformerConfig.from_dict(kw), jr.RoformerConfig.from_dict(kw)
        assert p.band_dims() == j.band_dims() and p.kind == j.kind
    idx, denom = pr._mel_indices(pr.RoformerConfig.from_dict(pr.DEFAULT_MEL_MODEL))
    jidx, jdenom = jr._mel_indices(jr.RoformerConfig.from_dict(jr.DEFAULT_MEL_MODEL))
    assert np.array_equal(idx, jidx) and np.array_equal(denom, jdenom)
