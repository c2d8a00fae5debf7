"""v3/v4 CFM training steps in the port (train/s2_train_v3.py) held
against the JAX package's make_train_step / make_lora_train_step on the
CPU at tiny widths, with JAX's draws fed in: one full step (v4): the loss,
every gradient (read from JAX's first Adam moment), both moments and every
parameter's change; the frozen groups bit-equal. The LoRA step is in
test_torch_train_v3_lora.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from gpt_sovits_tpu.train import s2_train_v3 as jt
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.train import s2_train_v3 as pt
from gpt_sovits_tpu_torch.utils import config as pconfig

from test_torch_train_v3 import (
    B, GRAD_BAR, TINY, TMEL, TS, UPDATE_BAR, ZERO_GRAD, batch_np, forward_draws, port_model, rel, setup, to_torch,
)

torch.set_num_threads(1)
# Adam's first step moves an element by lr * g / (|g| + eps): where |g| is
# within ~1000x of eps (1e-9) it follows g's last float32 digits, which
# reorder between any two implementations. Those elements' changes are held
# through their gradients and moments (compared in full); the change is
# compared where |g| > WELL_CONDITIONED.
WELL_CONDITIONED = 1e-6


def jax_state(jm, params, tc):
    return jt.V3TrainState(jnp.zeros((), jnp.int32), jax.tree.map(jnp.array, params),
                           jt.make_optimizer(tc, 4).init(params["params"]))


def adam_state(opt, p):
    st = opt.inner.state[p]
    return st["exp_avg"].numpy(), st["exp_avg_sq"].numpy()


def test_full_step_matches_jax():
    """One update: loss, every gradient (read from JAX's first Adam moment),
    both moments, every parameter's change; the frozen groups bit-equal."""
    jcfg, jm, params = setup("v4")
    tc = jconfig.TrainConfig(batch_size=B)
    bn = batch_np(3)
    rng = jax.random.PRNGKey(11)
    jnew, jmet = jt.make_train_step(jm, tc, 4)(jax_state(jm, params, tc), {k: jnp.asarray(v) for k, v in bn.items()},
                                               rng)
    adam = jnew.opt_state.inner_states["base"].inner_state[0]
    b1 = tc.betas[0]
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    named = lambda tree: {k: v.numpy() for k, v in weights.s2v3_from_jax(  # noqa: E731
        {"params": jax.tree.map(lambda x, p: np.zeros_like(p) if masked(x) else np.asarray(x), tree,
                                params["params"], is_leaf=masked)}, jcfg).items()}
    j_mu, j_nu = named(adam.mu), named(adam.nu)
    j_new = named(jnew.params["params"])
    before = {k: v.numpy() for k, v in weights.s2v3_from_jax(params, jcfg).items()}

    pm = port_model(jcfg, params)
    opt = pt.make_optimizer(pm, pconfig.TrainConfig(batch_size=B), 4)
    tb = to_torch(bn)
    t = min(TMEL, int(2 * (TS // 2) * pm.interp_factor))
    m = pt.make_train_step(pm, opt)(tb, draws=forward_draws(jax.random.fold_in(rng, 0), B, t, TINY["cfm_mel_channels"]))
    assert rel(m["cfm_loss"].item(), float(jmet["cfm_loss"])) < 1e-5
    labels = pt.label_params(pm)
    assert {"frozen", "base"} == set(labels.values())
    for name, p in pm.named_parameters():
        key = name if name in before else name[: -len("weight")] + "weight_v"  # wns1's weight-norm pairs
        if labels[name] == "frozen":
            assert p.grad is None and not p.requires_grad, name
            np.testing.assert_array_equal(p.detach().numpy(), before[key], err_msg=name)
            np.testing.assert_array_equal(j_new[key], before[key], err_msg=name)
            continue
        mu, nu = adam_state(opt, p)
        assert rel(p.grad.numpy(), j_mu[key] / (1 - b1)) < GRAD_BAR or name.endswith(ZERO_GRAD), name
        assert rel(mu, j_mu[key]) < UPDATE_BAR or name.endswith(ZERO_GRAD), name
        assert rel(nu, j_nu[key]) < UPDATE_BAR or name.endswith(ZERO_GRAD), name
        if not name.endswith(ZERO_GRAD):
            sure = np.abs(j_mu[key] / (1 - b1)) > WELL_CONDITIONED
            assert sure.mean() > 0.5, name
            assert rel((p.detach().numpy() - before[key])[sure], (j_new[key] - before[key])[sure]) < UPDATE_BAR, name
