"""The port's training data, checkpoints and drivers (train/data.py,
train/ckpt.py, run.py) against the JAX package on the CPU: the bucket
sampler's batches, the S1/S2 collates on a written corpus (with and without
`7-sv_cn`), reference-format exports equal to the JAX exporters' and read
by the JAX reader, resumption equal to an uninterrupted run, the drivers end
to end with `device="cpu"` and a pretrained reload, and `device=None`
refusing to run without a card (data-parallel or not)."""

import dataclasses
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.models.vits import SynthesizerTrn as JSynth
from gpt_sovits_tpu.train import data as jdata
from gpt_sovits_tpu.utils import checkpoint_compat as jcc
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.discriminators import MultiPeriodDiscriminator, periods_for
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.parallel import sync
from gpt_sovits_tpu_torch.run import run_train_s1, run_train_s2
from gpt_sovits_tpu_torch.train import ckpt as ckpt_io
from gpt_sovits_tpu_torch.train import data as pdata
from gpt_sovits_tpu_torch.utils import config as pconfig

torch.set_num_threads(2)

DURATIONS = (2.2,) * 4 + (3.2,) * 4  # two batches of 4 an epoch, for S1 and for S2
SSL_DIM = 32
S1 = dict(vocab_size=1025, embedding_dim=16, hidden_dim=16, num_heads=2, ffn_dim=32, num_layers=2)
S2 = dict(spec_channels=1025, segment_size=4, inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
          n_layers=2, upsample_rates=(10, 8, 8), upsample_kernel_sizes=(20, 16, 16), upsample_initial_channel=16,
          resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), gin_channels=8, mrte_hidden=8,
          ssl_dim=SSL_DIM, n_codes=12, sv_dim=24)
QUIET = dict(log=lambda *a, **k: None)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """MetricsLogger's TensorBoard writer is optional, and importing it can
    pull in TensorFlow (seconds of start-up), so the tests run without it
    (JSONL only)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's checkpoints and exports are deleted when it ends, passed
    or failed: a full S2 state holds the full-width discriminator and its
    AdamW moments (~765 MB a file)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    exp = tmp_path_factory.mktemp("exp")
    chip_smoke.write_corpus(exp, DURATIONS, seed=0, ssl_dim=SSL_DIM, sv_dim=S2["sv_dim"])
    return str(exp)


@pytest.fixture(scope="module")
def corpus_small(tmp_path_factory):
    """One batch of 4 an epoch: the S2 steps, whose full-width discriminator
    dominates a CPU step, stay few."""
    exp = tmp_path_factory.mktemp("exp_small")
    chip_smoke.write_corpus(exp, DURATIONS[:4], seed=2, ssl_dim=SSL_DIM, sv_dim=S2["sv_dim"])
    return str(exp)


@pytest.fixture(scope="module")
def corpus_no_sv(tmp_path_factory):
    exp = tmp_path_factory.mktemp("exp_nosv")
    chip_smoke.write_corpus(exp, DURATIONS, seed=1, ssl_dim=SSL_DIM, sv=False)
    return str(exp)


def s1_cfg():
    return pconfig.S1Config(**S1)


def s2_cfg(version="v2ProPlus"):
    return pconfig.S2Config(version=version, **S2)


@pytest.mark.parametrize("lengths_seed,batch_size,shards", [(0, 4, 1), (1, 3, 1), (2, 2, 2), (3, 5, 3)])
def test_bucket_sampler_batches_equal_jax(lengths_seed, batch_size, shards):
    lengths = np.random.default_rng(lengths_seed).integers(20, 400, 57)
    for shard in range(shards):
        ours = pdata.BucketSampler(lengths, batch_size, seed=7, num_shards=shards, shard_id=shard)
        theirs = jdata.BucketSampler(lengths, batch_size, seed=7, num_shards=shards, shard_id=shard)
        for epoch in range(3):
            a, b = ours.epoch_batches(epoch), theirs.epoch_batches(epoch)
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), (epoch, shard)


def test_s1_collate_equals_jax(corpus):
    ours, theirs = pdata.S1Dataset(corpus), jdata.S1Dataset(corpus)
    assert [it.name for it in ours.items] == [it.name for it in theirs.items] and len(ours) == len(DURATIONS)
    assert ours.lengths() == theirs.lengths()
    for idxs in pdata.BucketSampler(ours.lengths(), 4).epoch_batches(0):
        a, b = ours.collate(idxs), theirs.collate(idxs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("with_sv", [True, False])
def test_s2_collate_equals_jax(corpus, corpus_no_sv, with_sv):
    exp = corpus if with_sv else corpus_no_sv
    mel = dict(sampling_rate=32000, n_fft=2048, win_size=2048, hop_size=640, num_mels=128)
    ours = pdata.S2Dataset(exp, mel_cfg=pconfig.MelConfig(**mel))
    theirs = jdata.S2Dataset(exp, mel_cfg=jconfig.MelConfig(**mel))
    assert ours.names == theirs.names and ours.lengths() == theirs.lengths()
    for idxs in pdata.BucketSampler(ours.lengths(), 4).epoch_batches(0):
        a, b = ours.collate(idxs), theirs.collate(idxs)
        assert a.keys() == b.keys() and ("sv_emb" in a) == with_sv
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k == "spec":  # torch.stft against JAX's matmul DFT
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batch_to_dtypes(corpus):
    b = pdata.batch_to(pdata.S1Dataset(corpus).collate([0, 1]), "cpu")
    assert b["phoneme_ids"].dtype == torch.long and b["bert_features"].dtype == torch.float32


def plain(sd: dict) -> dict:
    """A state dict with weight-norm pairs -> plain weights: the pairs are
    written with v = w exactly (weights.py `_conv`), so v is the weight."""
    return {k.replace(".weight_v", ".weight"): v for k, v in sd.items() if not k.endswith(".weight_g")}


def _seeded(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)


def test_exports_equal_the_jax_exporters(tmp_path):
    """The port's .pth/.ckpt hold, in fp16, exactly what the JAX package's
    s2_params_to_torch/s1_params_to_torch write (enc_q dropped, weight norm
    split), under the version bytes; the JAX reader loads them; the .npz
    holds the same fp16 tensors under the same names."""
    jc2 = jconfig.S2Config(version="v2ProPlus", **S2)
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1), "slice": jax.random.PRNGKey(2)}
    z = jnp.zeros
    params = _seeded(jax.eval_shape(lambda: JSynth(jc2).init(
        keys, z((1, 8, SSL_DIM)), z((1, 10, 1025)), jnp.asarray([10]), z((1, 5), jnp.int32), jnp.asarray([5]),
        sv_emb=z((1, S2["sv_dim"])), method=JSynth.init_all)), 0)
    model = SynthesizerTrn(s2_cfg(), posterior=True)
    model.load_state_dict(plain(weights.s2_from_jax(params, jc2)), strict=True)
    ref = ckpt_io.s2_reference_state(model.state_dict())
    path = ckpt_io.save_reference_pth(ref, str(tmp_path / "g.pth"), model_version="v2ProPlus",
                                      config={"version": "v2ProPlus"}, info="1epoch")
    assert open(path, "rb").read(2) == b"06"
    assert jcc.sniff_sovits_version(path) == ("v2", "v2ProPlus", False)
    expect = {k: v.half() for k, v in jcc.s2_params_to_torch(params, jc2).items() if not k.startswith("enc_q.")}
    got = jcc.load_torch_checkpoint(path)
    assert got["info"] == "1epoch" and set(got["weight"]) == set(expect)
    for k, v in expect.items():
        assert torch.equal(got["weight"][k], v), k
    assert any(k.endswith("weight_g") for k in expect)
    assert ckpt_io.load_torch_checkpoint(path)["weight"].keys() == expect.keys()  # the port's reader

    npz = np.load(ckpt_io.export_weights(ref, str(tmp_path / "g.npz"), config={"version": "v2ProPlus"}, info="x"))
    assert json.loads(str(npz["__meta__"])) == {"config": {"version": "v2ProPlus"}, "info": "x"}
    for k, v in expect.items():
        assert npz[k].dtype == np.float16 and np.array_equal(npz[k], v.numpy()), k

    jc1 = jconfig.S1Config(**S1)
    p1 = _seeded(jax.eval_shape(lambda: JT2S(jc1).init(jax.random.PRNGKey(0), method=JT2S.init_all)), 1)
    s1 = T2SDecoder(s1_cfg())
    s1.load_state_dict(weights.s1_from_jax(p1, jc1), strict=True)
    path1 = ckpt_io.save_reference_pth(s1.state_dict(), str(tmp_path / "s1.ckpt"))
    got1 = jcc.load_torch_checkpoint(path1)["weight"]
    exp1 = jcc.s1_params_to_torch(p1, jc1)
    assert set(got1) == set(exp1)
    for k, v in exp1.items():
        assert torch.equal(got1[k], v.half()), k


def _final_state(ckpt_dir):
    return ckpt_io.load_checkpoint(ckpt_io.latest_checkpoint(ckpt_dir))


def _assert_states_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_states_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_states_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_s1_resume_equals_uninterrupted(corpus, tmp_path):
    """2 micro-steps an epoch against accumulation over 4: the checkpoint after
    epoch 1 holds half an accumulation, which the resumed run completes."""
    kw = dict(batch_size=4, save_every=1, dpo=True, model_cfg=s1_cfg(), device="cpu", **QUIET)
    run_train_s1(corpus, str(tmp_path / "a"), epochs=3, **kw)
    run_train_s1(corpus, str(tmp_path / "b"), epochs=1, **kw)
    assert _final_state(str(tmp_path / "b"))["optimizers"]["s1"]["mini_step"] == 2
    r = run_train_s1(corpus, str(tmp_path / "b"), epochs=3, **kw)
    assert r["resumed_from"].endswith("state_2") and r["step"] == 6
    a, b = _final_state(str(tmp_path / "a")), _final_state(str(tmp_path / "b"))
    assert a["optimizers"]["s1"]["updates"] == 1 and a["optimizers"]["s1"]["mini_step"] == 2
    _assert_states_equal(a, b)


def test_s2_resume_equals_uninterrupted(corpus_small, tmp_path):
    kw = dict(version="v2ProPlus", batch_size=4, model_cfg=s2_cfg(), device="cpu", **QUIET)
    run_train_s2(corpus_small, str(tmp_path / "a"), epochs=2, save_every=2, **kw)
    run_train_s2(corpus_small, str(tmp_path / "b"), epochs=1, save_every=1, **kw)
    r = run_train_s2(corpus_small, str(tmp_path / "b"), epochs=2, save_every=1, **kw)
    assert r["resumed_from"].endswith("state_1") and r["step"] == 2
    _assert_states_equal(_final_state(str(tmp_path / "a")), _final_state(str(tmp_path / "b")))


def test_drivers_end_to_end_with_pretrained(corpus_small, tmp_path):
    """run_train_s2 then run_train_s1 on the corpus; their exports reload as
    `pretrained_*` into fresh runs (S2's without enc_q, which keeps its
    fresh values); metrics land in logs/metrics.jsonl."""
    corpus = corpus_small
    r2 = run_train_s2(corpus, str(tmp_path / "s2"), version="v2ProPlus", batch_size=4, epochs=1, save_every=1,
                      model_cfg=s2_cfg(), device="cpu", **QUIET)
    names = sorted(p.rsplit("/", 1)[1] for p in r2["exports"])
    assert names == ["s2G-e1.npz", "s2G-e1.pth"] and np.isfinite(r2["metrics"]["loss_g"])
    recs = [json.loads(x) for x in open(tmp_path / "s2" / "logs" / "metrics.jsonl")]
    assert recs[-1]["step"] == 1 and "loss_d" in recs[-1]
    d_path = str(tmp_path / "s2D.pth")
    torch.save({"weight": {f"module.{k}": v for k, v in r2["models"]["d"].state_dict().items()}}, d_path)
    r = run_train_s2(corpus, str(tmp_path / "s2b"), version="v2ProPlus", batch_size=4, epochs=0,
                     pretrained_s2g=str(tmp_path / "s2" / "s2G-e1.pth"), pretrained_s2d=d_path,
                     model_cfg=s2_cfg(), device="cpu", **QUIET)
    g, d = r["models"]["g"], r["models"]["d"]
    trained = r2["models"]["g"].state_dict()
    for k, v in g.state_dict().items():
        if not k.startswith("enc_q."):
            torch.testing.assert_close(v, trained[k], rtol=2e-3, atol=2e-4)  # through fp16 and weight norm
    for k, v in d.state_dict().items():
        assert torch.equal(v, r2["models"]["d"].state_dict()[k]), k

    r1 = run_train_s1(corpus, str(tmp_path / "s1"), batch_size=4, epochs=1, save_every=1, model_cfg=s1_cfg(),
                      device="cpu", **QUIET)
    assert np.isfinite(r1["metrics"]["loss"]) and r1["step"] == 1
    r = run_train_s1(corpus, str(tmp_path / "s1b"), batch_size=4, epochs=0,
                     pretrained_s1=str(tmp_path / "s1" / "s1-e1.ckpt"), model_cfg=s1_cfg(), device="cpu", **QUIET)
    for k, v in r["models"]["s1"].state_dict().items():
        assert torch.equal(v, r1["models"]["s1"].state_dict()[k].half().float()), k


def test_device_none_needs_a_card_and_no_data_parallel(corpus, tmp_path, monkeypatch):
    """device=None needs a card; data_parallel=True without a process group
    of more than one is no data parallelism, and a card is still needed;
    with one (here a stand-in world of 2) a batch it does not divide is
    refused before anything is written (tests/test_torch_parallel.py runs
    real groups)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train_s1(corpus, str(tmp_path / "c"), model_cfg=s1_cfg(), **QUIET)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train_s2(corpus, str(tmp_path / "c"), model_cfg=s2_cfg(), **QUIET)
    for fn in (run_train_s1, run_train_s2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(corpus, str(tmp_path / "c"), data_parallel=True, **QUIET)
    monkeypatch.setattr(sync, "world", lambda: 2)
    for fn in (run_train_s1, run_train_s2):
        with pytest.raises(ValueError, match="not divisible by 2"):
            fn(corpus, str(tmp_path / "c"), batch_size=3, data_parallel=True, device="cpu", **QUIET)
    assert not (tmp_path / "c").exists()


def test_training_models_hold_float32_and_refuse_else(corpus, tmp_path):
    from gpt_sovits_tpu_torch.run import _check_f32

    gen = SynthesizerTrn(s2_cfg(), posterior=True)
    _check_f32(gen, MultiPeriodDiscriminator(periods_for(s2_cfg())))
    with pytest.raises(TypeError, match="float32"):
        _check_f32(T2SDecoder(s1_cfg()).to(torch.bfloat16))
