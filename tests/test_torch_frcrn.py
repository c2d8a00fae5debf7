"""The port's FRCRN denoiser (gpt_sovits_tpu_torch/models/frcrn.py) against
the JAX package's (gpt_sovits_tpu/models/frcrn.py) on the CPU, at the tiny
config of tests/test_frcrn.py and with BatchNorm statistics randomised: the
STFT pair, every complex block and the whole cascade within 2e-5 (the JAX
test's own bar); the weight round trip through JAX's importer exact
(`frcrn_from_jax(params_from_torch(sd)) == sd`), also at the published
config's shapes; `load_frcrn` on a checkpoint file."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.models import frcrn as jf
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models import frcrn as pf

TINY = dict(complexity=4, channels=(1, 1, 2), fsmn_hidden=8, fsmn_lorder=3)
TOL = 2e-5


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def seeded_model(cfg: pf.FRCRNConfig, seed: int = 0) -> pf.FRCRN:
    torch.manual_seed(seed)
    m = pf.FRCRN(cfg)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2)
                mod.running_var.uniform_(0.5, 1.5)
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.uniform_(-0.2, 0.2)
    return m.eval()


def numpy_sd(m) -> dict:
    return {k: v.numpy() for k, v in m.state_dict().items() if not k.endswith("num_batches_tracked")}


def test_stft_pair_equals_jax():
    x = np.random.default_rng(0).standard_normal((2, 8000)).astype(np.float32)
    rj, ij = jf.frcrn_stft(jnp.asarray(x))
    rp, ip = pf.frcrn_stft(torch.from_numpy(x))
    assert rp.shape == (2, 321, 26)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), atol=TOL * 20)  # |X| up to ~60: 2e-5 relative
    np.testing.assert_allclose(ip.numpy(), np.asarray(ij), atol=TOL * 20)
    y = pf.frcrn_istft(rp, ip, 8000).numpy()
    np.testing.assert_allclose(y, np.asarray(jf.frcrn_istft(rj, ij, 8000)), atol=TOL)
    np.testing.assert_allclose(y, x, atol=TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_complex_convolutions_equal_jax(transpose):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 6, 5, 4, 2)).astype(np.float32)  # JAX's (B, F, T, C, ri)
    if transpose:
        jm = jf.ComplexConvTranspose2d(3, (5, 3), (2, 1), ((2, 2), (1, 1)), output_padding=(1, 0))
        pm = pf.ComplexConvTranspose2d(4, 3, (5, 3), (2, 1), (2, 1), (1, 0))
    else:
        jm = jf.ComplexConv2d(3, (5, 3), (2, 1), ((2, 2), (1, 1)))
        pm = pf.ComplexConv2d(4, 3, (5, 3), (2, 1), (2, 1))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pm.load_state_dict({f"{part}.{name}": t for (part, name), t in
                        ((tuple(k.split(".")), t) for k, t in weights.frcrn_from_jax(v).items())}, strict=True)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x.transpose(4, 0, 3, 1, 2).copy())).numpy()  # (ri, B, C, F, T)
    assert got.shape == want.transpose(4, 0, 3, 1, 2).shape
    np.testing.assert_allclose(got, want.transpose(4, 0, 3, 1, 2), atol=TOL)


def test_fsmn_equals_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 5, 6, 2)).astype(np.float32)
    jm = jf.ComplexFSMN(8, 6, lorder=3)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    pm = pf.ComplexFSMN(6, 8, 6, lorder=3)
    pm.load_state_dict(weights.frcrn_from_jax(v), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x.transpose(4, 0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))).transpose(4, 0, 3, 1, 2), atol=TOL)


@pytest.mark.parametrize("length", [4800, 5123])
def test_frcrn_equals_jax(length):
    m = seeded_model(pf.FRCRNConfig(**TINY), seed=length)
    params = jf.params_from_torch(numpy_sd(m), jf.FRCRNConfig(**TINY))
    x = (0.3 * np.random.default_rng(length).standard_normal((2, length))).astype(np.float32)
    wj, (mrj, mij) = jf.FRCRN(jf.FRCRNConfig(**TINY)).apply(params, jnp.asarray(x))
    with torch.no_grad():
        wp, (mrp, mip) = m(torch.from_numpy(x))
    assert wp.shape == (2, length) and mrp.shape == np.asarray(mrj).shape
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=TOL)
    np.testing.assert_allclose(mrp.numpy(), np.asarray(mrj), atol=TOL)
    np.testing.assert_allclose(mip.numpy(), np.asarray(mij), atol=TOL)
    assert float(mrp.abs().max()) <= 2.0  # tanh + tanh


@pytest.mark.parametrize("cfg", [TINY, {}], ids=["tiny", "published"])
def test_weight_round_trip_through_the_jax_importer_is_exact(cfg):
    m = seeded_model(pf.FRCRNConfig(**cfg))
    sd = numpy_sd(m)
    back = weights.frcrn_from_jax(jax.tree.map(np.asarray, jf.params_from_torch(sd, jf.FRCRNConfig(**cfg))))
    assert set(back) == set(sd)
    for k in sd:
        assert np.array_equal(back[k].numpy(), sd[k]), k


def test_losses_equal_jax():
    rng = np.random.default_rng(4)
    est, ref = (rng.standard_normal((3, 1600)).astype(np.float32) for _ in range(2))
    est = ref + 0.3 * est
    np.testing.assert_allclose(pf.si_snr(torch.from_numpy(est), torch.from_numpy(ref)).numpy(),
                               np.asarray(jf.si_snr(jnp.asarray(est), jnp.asarray(ref))), rtol=1e-5)
    np.testing.assert_allclose(float(pf.frcrn_loss(torch.from_numpy(est), torch.from_numpy(ref))),
                               float(jf.frcrn_loss(jnp.asarray(est), jnp.asarray(ref))), rtol=1e-5)


def test_load_frcrn_reads_a_checkpoint_file(tmp_path):
    m = seeded_model(pf.FRCRNConfig(**TINY))
    path = tmp_path / "pytorch_model.bin"
    torch.save({"state_dict": {"model." + k: v for k, v in m.state_dict().items()}}, path)
    got = pf.load_frcrn(str(path), pf.FRCRNConfig(**TINY), device="cpu")
    for k, v in m.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    assert not got.training
    with pytest.raises(ValueError):
        pf.load_frcrn_state(pf.FRCRN(pf.FRCRNConfig(**TINY)), {**m.state_dict(), "unet.extra.weight": torch.zeros(1)})
    bad = dict(m.state_dict())
    bad["unet.enc_0.real.weight"] = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError):
        pf.load_frcrn_state(pf.FRCRN(pf.FRCRNConfig(**TINY)), bad)
    with pytest.raises(KeyError):
        pf.load_frcrn_state(pf.FRCRN(pf.FRCRNConfig(**TINY)), {"unet.enc_0.real.weight": bad["unet.enc_0.real.weight"]})
