"""v3/v4 CFM training in the port (models/v3.py) held against the JAX
package on the CPU at tiny widths: CFM.loss in both branches, the training
forward of v3 and v4 and SynthesizerTrnV3b's forward and decode_encp, with
JAX's draws fed in. This file holds CFM.loss and the shared helpers; the steps are in test_torch_train_v3_step.py, the data
and the entry point in test_torch_train_v3_run.py, the forwards in
test_torch_train_v3_forward.py and test_torch_train_v3b.py (one file
each, so that the JAX compilations spread over the workers)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3 as JV3
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
from gpt_sovits_tpu_torch.train import s2_train_v3 as pt
from gpt_sovits_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

TINY = dict(spec_channels=65, inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2, n_layers=2,
            kernel_size=3, gin_channels=16, mrte_hidden=16, ssl_dim=16, n_codes=17, cfm_mel_channels=12,
            cfm_dit_depth=2, cfm_dit_dim=32, cfm_dit_heads=2)
V3B = dict(TINY, version="v3", segment_size=8, upsample_rates=(8, 8), upsample_initial_channel=32,
           upsample_kernel_sizes=(16, 16), resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
B, TS, TSPEC, TT, TMEL = 2, 24, 24, 6, 45
GRAD_BAR = 1e-4  # relative L2, per tensor
UPDATE_BAR = 1e-3  # relative L2 of a parameter's change, and of each Adam moment
# biases whose gradient is zero in exact arithmetic (a key bias shifts every
# score of a softmax row alike): Adam's first step follows their rounding noise
ZERO_GRAD = (".to_k.bias", ".w_ks.bias")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def seeded_params(init_fn, seed: int) -> dict:
    """A flax tree of init_fn's shapes from a numpy seed (kernels at
    1/sqrt(fan-in)); tracing compiles nothing."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        if name == "embed":
            return rng.uniform(-1, 1, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" else 1
        std = 0.1 if name in ("bias", "gamma", "beta") else (0.5 if name.startswith("emb") else fan_in**-0.5)
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn))


def batch_np(seed=0, mel_dim=TINY["cfm_mel_channels"]):
    rng = np.random.default_rng(seed)
    return {
        "ssl": rng.standard_normal((B, TS, TINY["ssl_dim"])).astype(np.float32),
        "spec": (np.abs(rng.standard_normal((B, TSPEC, TINY["spec_channels"]))) * 0.3).astype(np.float32),
        "spec_lengths": np.asarray([TSPEC, TSPEC - 4], np.int32),
        "mel": (rng.standard_normal((B, TMEL, mel_dim)) * 0.3).astype(np.float32),
        "mel_lengths": np.asarray([TMEL, TMEL - 6], np.int32),
        "text": rng.integers(0, 700, (B, TT)).astype(np.int32),
        "text_lengths": np.asarray([TT, TT - 2], np.int32),
    }


def to_torch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in b.items()}


def jax_init(model, b, method):
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    return lambda: model.init(keys, *(jnp.asarray(b[k]) for k in pt.BATCH_KEYS), method=method)


@functools.lru_cache(maxsize=2)
def setup(version: str):
    """The JAX model of `version` at TINY and its parameters from a seed."""
    jcfg = jconfig.S2Config(version=version, **TINY)
    jm = JV3(jcfg)
    params = seeded_params(jax_init(jm, batch_np(), JV3.init_all), {"v3": 1, "v4": 2}[version])
    return jcfg, jm, params


def port_model(jcfg, params):
    pm = SynthesizerTrnV3(pconfig.S2Config(version=jcfg.version, **TINY))
    pm.load_state_dict(weights.s2v3_from_jax(params, jcfg), strict=True)
    return pm


def cfm_draws(rng, b, t, mel_dim):
    """JAX CFM.loss's draws from its key (models/v3.py:342-353)."""
    k_t, k_noise, k_boot, k_base = jax.random.split(rng, 4)
    return {"tt": torch.from_numpy(np.array(jax.random.uniform(k_t, (b,)))),
            "x0": torch.from_numpy(np.array(jax.random.normal(k_noise, (b, t, mel_dim)))),
            "use_boot": torch.tensor(bool(jax.random.uniform(k_boot, ()) < 0.3)),
            "base": torch.from_numpy(np.array(jax.random.randint(k_base, (b,), 2, 8))).long()}


def forward_draws(rng, b, t, mel_dim):
    """SynthesizerTrnV3.__call__'s draws from its key: the prompt uniform,
    then CFM.loss's."""
    k1, k2 = jax.random.split(rng)
    return {"prompt_u": torch.from_numpy(np.array(jax.random.uniform(k1, (b,)))), **cfm_draws(k2, b, t, mel_dim)}


def key_with_boot(boot: bool, split: bool) -> jax.Array:
    """The first PRNGKey(i) whose bootstrap coin comes up `boot` (split:
    the coin of the forward's second key)."""
    for i in range(100):
        k = jax.random.PRNGKey(i)
        kc = jax.random.split(k)[1] if split else k
        if bool(jax.random.uniform(jax.random.split(kc, 4)[2], ()) < 0.3) == boot:
            return k
    raise AssertionError("no key")


@pytest.mark.parametrize("boot", [False, True])
def test_cfm_loss_matches_jax_in_both_branches(boot):
    jcfg, jm, params = setup("v4")
    rng = np.random.default_rng(5)
    t, m = 40, TINY["cfm_mel_channels"]
    x1 = rng.standard_normal((B, t, m)).astype(np.float32) * 0.5
    mu = rng.standard_normal((B, t, 512)).astype(np.float32) * 0.5
    x_lens, prompt_lens = np.asarray([40, 31], np.int32), np.asarray([9, 0], np.int32)
    key = key_with_boot(boot, split=False)

    def jloss(p, mu_):
        return jm.apply(p, jnp.asarray(x1), jnp.asarray(x_lens), jnp.asarray(prompt_lens), mu_, key,
                        method=lambda mdl, *a: mdl.cfm.loss(*a))

    jl, jg = jax.value_and_grad(jloss, argnums=1)(params, jnp.asarray(mu))
    pm = port_model(jcfg, params)
    draws = cfm_draws(key, B, t, m)
    assert bool(draws["use_boot"]) == boot
    mu_t = torch.from_numpy(mu).requires_grad_(True)
    loss = pm.cfm.loss(torch.from_numpy(x1), torch.from_numpy(x_lens).long(), torch.from_numpy(prompt_lens).long(),
                       mu_t, draws)
    loss.backward()
    assert rel(loss.item(), float(jl)) < 1e-5, (loss.item(), float(jl))
    assert rel(mu_t.grad.numpy(), np.asarray(jg)) < GRAD_BAR
