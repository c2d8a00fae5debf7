"""v3/v4 training data and the entry point in the port (train/data.py V3Dataset,
run.py run_train_v3) on a corpus the test writes, on the CPU: the collate
against the JAX package's; a full fine-tune resumed equal to an
uninterrupted one, its `.pth` export (version header, the tensors of the
JAX exporter `s2v3_params_to_torch` on the same weights, a strict reload)
and `pretrained=` from it; a LoRA run whose base never moves and whose
export holds the merged weights."""

import shutil
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gpt_sovits_tpu.train import data as jdata
from gpt_sovits_tpu.utils import checkpoint_compat as jcc
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
from gpt_sovits_tpu_torch.run import run_train_v3
from gpt_sovits_tpu_torch.train import ckpt as ckpt_io
from gpt_sovits_tpu_torch.train import data as pdata
from gpt_sovits_tpu_torch.train.s2_train_v3 import merge_lora
from gpt_sovits_tpu_torch.utils import config as pconfig
from test_torch_train_data import _assert_states_equal

torch.set_num_threads(2)

DURATIONS = (1.4,) * 2 + (1.5,) * 2  # one bucket: two batches of 2 an epoch
SSL_DIM = 16
TINY = dict(spec_channels=1025, inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=2,
            kernel_size=3, gin_channels=8, mrte_hidden=8, ssl_dim=SSL_DIM, n_codes=12, cfm_mel_channels=100,
            cfm_dit_depth=2, cfm_dit_dim=32, cfm_dit_heads=2)
QUIET = dict(log=lambda *a, **k: None)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL only (test_torch_train_data.py)


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's checkpoints and exports are deleted when it ends, passed
    or failed (the runs' full states and fp16 exports, ~2 GB a test)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    exp = tmp_path_factory.mktemp("exp_v3")
    chip_smoke.write_corpus(exp, DURATIONS, seed=3, ssl_dim=SSL_DIM, sv=False)
    return str(exp)


def cfg(version):
    return pconfig.S2Config(version=version, **TINY)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("version", ["v3", "v4"])
def test_v3_collate_equals_jax(corpus, version):
    ds, jds = pdata.V3Dataset(corpus, version=version), jdata.V3Dataset(corpus, version=version)
    assert ds.names == jds.names and ds.lengths() == jds.lengths() and len(ds) == 4
    idx = [1, 3]
    got, want = ds.collate(idx), jds.collate(idx)
    assert got.keys() == want.keys()
    assert ds.reads == {"native": 1, "python": 0}  # g++ is here: the native reader ran
    assert got["spec"].shape[1] == 128 and got["ssl"].shape[1] == 256 and got["mel"].shape[1:] == (256, 100)
    for k, v in want.items():
        if v.dtype.kind == "i":
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k].shape == v.shape and rel(got[k], v) < 1e-4, (k, rel(got[k], v))


def test_full_run_resumes_exports_and_reloads(corpus, tmp_path):
    kw = dict(version="v4", batch_size=2, save_every=1, model_cfg=cfg("v4"), device="cpu", **QUIET)
    a = run_train_v3(corpus, str(tmp_path / "a"), epochs=2, **kw)
    run_train_v3(corpus, str(tmp_path / "b"), epochs=1, **kw)
    b = run_train_v3(corpus, str(tmp_path / "b"), epochs=2, **kw)
    assert b["resumed_from"].endswith("state_2") and a["step"] == b["step"] == 4 and a["reads"]["native"] == 4
    _assert_states_equal(*(ckpt_io.load_checkpoint(ckpt_io.latest_checkpoint(str(tmp_path / d))) for d in "ab"))
    assert np.isfinite(a["metrics"]["cfm_loss"])

    pth = tmp_path / "a" / "s2G-v4-e2.pth"
    assert pth.read_bytes()[:2] == b"04" and (tmp_path / "a" / "s2G-v4-e2.npz").exists()
    ck = ckpt_io.load_torch_checkpoint(str(pth))
    assert ck["config"] == {"version": "v4"} and ck["info"] == "2epoch"
    sd = a["models"]["s2"].state_dict()
    jparams = jcc.s2v3_params_from_torch({k: v.numpy() for k, v in sd.items()}, jconfig.S2Config(version="v4", **TINY))
    want = jcc.s2v3_params_to_torch(jparams, jconfig.S2Config(version="v4", **TINY))
    assert ck["weight"].keys() == want.keys() and any(k.endswith("weight_g") for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(ck["weight"][k].float().numpy(), torch.as_tensor(np.asarray(v)).half().float().numpy(),
                                   rtol=1e-3, atol=1e-7, err_msg=k)
    missing, unexpected = SynthesizerTrnV3(cfg("v4")).load_state_dict(ck["weight"], strict=True)
    assert not missing and not unexpected

    r = run_train_v3(corpus, str(tmp_path / "c"), epochs=0, pretrained=str(pth), **kw)
    for k, v in r["models"]["s2"].state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=2e-3, atol=2e-4)  # through fp16 and weight norm


def test_lora_run_keeps_the_base_and_exports_merged(corpus, tmp_path):
    kw = dict(version="v3", batch_size=2, save_every=1, lora_rank=2, model_cfg=cfg("v3"), device="cpu", **QUIET)
    a = run_train_v3(corpus, str(tmp_path / "a"), epochs=2, **kw)
    run_train_v3(corpus, str(tmp_path / "b"), epochs=1, **kw)
    b = run_train_v3(corpus, str(tmp_path / "b"), epochs=2, **kw)
    assert b["resumed_from"].endswith("state_2")
    _assert_states_equal(*(ckpt_io.load_checkpoint(ckpt_io.latest_checkpoint(str(tmp_path / d))) for d in "ab"))
    torch.manual_seed(1234)
    fresh = SynthesizerTrnV3(cfg("v3")).state_dict()
    base = a["models"]["s2"].state_dict()
    for k, v in fresh.items():  # the base weights never moved
        assert torch.equal(base[k], v), k
    lora = a["lora"]
    assert len(lora) == 4 * TINY["cfm_dit_depth"] and all(f["B"].abs().sum() > 0 for f in lora.values())
    ck = ckpt_io.load_torch_checkpoint(str(tmp_path / "a" / "s2G-v3-e2.pth"))
    assert ck["config"] == {"version": "v3", "lora_rank": 2}
    merged = ckpt_io.s2_reference_state(merge_lora(base, lora))
    assert ck["weight"].keys() == merged.keys()
    for k, v in merged.items():
        assert torch.equal(ck["weight"][k], v.half()), k
    SynthesizerTrnV3(cfg("v3")).load_state_dict(ck["weight"], strict=True)
