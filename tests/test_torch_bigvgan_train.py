"""BigVGAN GAN training in the port (train/bigvgan_train.py) against the
JAX package's on the CPU at tiny widths: the multi-scale mel loss, the
discriminators' outputs, and one G+D step with the generator on the plain
snake composition (use_kernel=False): the losses, every gradient (read from
JAX's first Adam moment), the moments and the parameters' changes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.models.bigvgan import BigVGAN as JBigVGAN
from gpt_sovits_tpu.models.bigvgan import BigVGANConfig as JBigVGANConfig
from gpt_sovits_tpu.train import bigvgan_train as jbt
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.bigvgan import AntiAliasedSnake, BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.train import bigvgan_train as pbt
from gpt_sovits_tpu_torch.utils import config as pconfig

torch.set_num_threads(2)

MEL = dict(sampling_rate=8000, n_fft=256, win_size=256, hop_size=64, num_mels=13)
CFG = dict(num_mels=13, upsample_rates=(4, 4, 2, 2), upsample_kernel_sizes=(8, 8, 4, 4), upsample_initial_channel=32,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
PERIODS = (2, 3)
RES = ((128, 32, 64), (256, 64, 128))
B, SEG = 2, 16
GRAD_BAR = 1e-4
UPDATE_BAR = 1e-3
WELL_CONDITIONED = 1e-6  # as test_torch_train_v3_step.py: Adam's first step where |g| >> eps


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def seeded(init_fn, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("alpha", "beta"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" else 1
        std = 0.1 if name == "bias" else fan_in**-0.5
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn))


def test_multiscale_mel_loss_matches_jax():
    rng = np.random.default_rng(1)
    y, y_hat = (rng.standard_normal((2, 4096)).astype(np.float32) * 0.1 for _ in range(2))
    want = float(jbt.multiscale_mel_loss(jnp.asarray(y), jnp.asarray(y_hat), jconfig.MelConfig(**MEL)))
    got = pbt.multiscale_mel_loss(torch.from_numpy(y), torch.from_numpy(y_hat), pconfig.MelConfig(**MEL))
    assert rel(got.item(), want) < 1e-5
    assert pbt.multiscale_mel_loss(torch.from_numpy(y), torch.from_numpy(y), pconfig.MelConfig(**MEL)).item() == 0.0


def test_discriminators_match_jax():
    jd = jbt.BigVGANDiscriminators(periods=PERIODS, resolutions=RES)
    rng = np.random.default_rng(2)
    y, y_hat = (rng.standard_normal((B, 1024, 1)).astype(np.float32) * 0.3 for _ in range(2))
    params = seeded(lambda: jd.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y_hat)), 3)
    jr, jg, jfr, jfg = jax.jit(jd.apply)(params, jnp.asarray(y), jnp.asarray(y_hat))
    d = pbt.BigVGANDiscriminators(PERIODS, RES)
    d.load_state_dict(weights.bigvgan_d_from_jax(params, PERIODS, RES), strict=True)
    with torch.no_grad():
        r, g, fr, fg = d(torch.from_numpy(y), torch.from_numpy(y_hat))
    assert len(r) == len(g) == len(fr) == len(fg) == 1 + len(PERIODS) + len(RES)
    for a, b in zip(r + g, jr + jg):
        assert a.shape == b.shape and rel(a.numpy(), np.asarray(b)) < 1e-5
    for dm, jdm in zip(fg, jfg):
        assert len(dm) == len(jdm)
        for a, b in zip(dm, jdm):
            assert rel(a.numpy(), np.moveaxis(np.asarray(b), -1, 1)) < 1e-5


@pytest.fixture(scope="module")
def step_results():
    gen, disc = JBigVGAN(JBigVGANConfig(**CFG)), jbt.BigVGANDiscriminators(periods=PERIODS, resolutions=RES)
    mel = jconfig.MelConfig(**MEL)
    tc = jconfig.TrainConfig(batch_size=B, learning_rate=2e-4)
    params_g = seeded(lambda: gen.init(jax.random.PRNGKey(0), jnp.zeros((1, SEG, 13))), 4)
    wav0 = jnp.zeros((1, SEG * MEL["hop_size"], 1))
    params_d = seeded(lambda: disc.init(jax.random.PRNGKey(1), wav0, wav0), 5)
    opt = jbt.optax.adamw(tc.learning_rate, b1=tc.betas[0], b2=tc.betas[1], eps=tc.eps)
    state = jbt.BigVGANTrainState(jnp.zeros((), jnp.int32), jax.tree.map(jnp.array, params_g),
                                  jax.tree.map(jnp.array, params_d), opt.init(params_g["params"]),
                                  opt.init(params_d["params"]))
    rng = np.random.default_rng(6)
    batch = {"mel": rng.standard_normal((B, SEG, 13)).astype(np.float32),
             "wav": (rng.standard_normal((B, SEG * MEL["hop_size"], 1)) * 0.1).astype(np.float32)}
    jnew, jm = jbt.make_train_step(gen, disc, tc, mel)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                                       jax.random.PRNGKey(2))
    jnew = jax.tree.map(np.asarray, jnew)

    pg = BigVGAN(BigVGANConfig(**CFG), use_kernel=False)
    pg.load_state_dict(weights.bigvgan_from_jax(params_g, BigVGANConfig(**CFG)), strict=True)
    pd = pbt.BigVGANDiscriminators(PERIODS, RES)
    pd.load_state_dict(weights.bigvgan_d_from_jax(params_d, PERIODS, RES), strict=True)
    before = {"g": {k: v.detach().clone() for k, v in pg.named_parameters()},
              "d": {k: v.detach().clone() for k, v in pd.named_parameters()}}
    st = pbt.init_state(pg, pd, pconfig.TrainConfig(batch_size=B, learning_rate=2e-4))
    m = pbt.make_train_step(pg, pd, st, pconfig.MelConfig(**MEL))({k: torch.from_numpy(v) for k, v in batch.items()})
    return {"jax": (jnew, jm), "port": (pg, pd, st, m), "before": before}


def test_step_losses_match_jax(step_results):
    jnew, jm = step_results["jax"]
    pg, _, st, m = step_results["port"]
    assert st.step == 1 and all(not a.use_kernel for a in pg.modules() if isinstance(a, AntiAliasedSnake))
    for k in ("loss_g", "loss_d", "loss_adv", "loss_fm", "loss_mel"):
        assert rel(m[k].item(), float(jm[k])) < 1e-5, (k, m[k].item(), float(jm[k]))


@pytest.mark.parametrize("which", ["g", "d"])
def test_step_gradients_moments_and_updates_match_jax(step_results, which):
    jnew, _ = step_results["jax"]
    pg, pd, st, _ = step_results["port"]
    model, opt = (pg, st.opt_g) if which == "g" else (pd, st.opt_d)
    adam = (jnew.opt_g if which == "g" else jnew.opt_d)[0]
    to_named = ((lambda t: weights.bigvgan_from_jax({"params": t}, BigVGANConfig(**CFG))) if which == "g"
                else (lambda t: weights.bigvgan_d_from_jax({"params": t}, PERIODS, RES)))
    j_mu, j_nu = to_named(adam.mu), to_named(adam.nu)
    j_new = to_named((jnew.params_g if which == "g" else jnew.params_d)["params"])
    before = step_results["before"][which]
    assert j_mu.keys() == dict(model.named_parameters()).keys()
    for name, p in model.named_parameters():
        g = j_mu[name].numpy() / (1 - pconfig.TrainConfig().betas[0])  # mu = (1 - b1) g after one step
        assert rel(p.grad.numpy(), g) < GRAD_BAR, (name, rel(p.grad.numpy(), g))
        st_ = opt.state[p]
        assert rel(st_["exp_avg"].numpy(), j_mu[name].numpy()) < UPDATE_BAR, name
        assert rel(st_["exp_avg_sq"].numpy(), j_nu[name].numpy()) < UPDATE_BAR, name
        sure = np.abs(g) > WELL_CONDITIONED
        du, dj = (p.detach() - before[name]).numpy(), (j_new[name] - before[name]).numpy()
        assert rel(du[sure], dj[sure]) < UPDATE_BAR, name
    if which == "g":  # the snakes' alpha and beta train through the plain composition
        assert pg.activation_post.act.alpha.grad.abs().sum() > 0
