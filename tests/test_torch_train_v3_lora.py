"""One LoRA step of v3 CFM training in the port (train/s2_train_v3.py)
against the JAX package's make_lora_train_step on the CPU at tiny widths,
JAX's draws fed in: the loss, the factors' gradients, moments and updates
(A = a.T, B = b.T), the base bit-equal on both sides; then merge_lora after
the step, with B != 0, against JAX's merge."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpt_sovits_tpu.train import s2_train_v3 as jt
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.train import s2_train_v3 as pt
from gpt_sovits_tpu_torch.utils import config as pconfig

from test_torch_train_v3 import (
    B, GRAD_BAR, TINY, TMEL, TS, UPDATE_BAR, batch_np, forward_draws, port_model, rel, setup, to_torch,
)

torch.set_num_threads(1)


def test_lora_step_and_merge_match_jax():
    """One LoRA update: the loss, the factors' gradients, moments and
    updates as JAX's (A = a.T, B = b.T); the base bit-equal on both sides;
    then merge_lora, with b != 0, against JAX's merge."""
    jcfg, jm, params = setup("v3")
    tc = jconfig.TrainConfig(batch_size=B, learning_rate=1e-3)
    jlora = jax.tree.map(np.asarray, jt.init_lora(params, 2, jax.random.PRNGKey(5)))
    jstate = jt.V3TrainState(jnp.zeros((), jnp.int32), jax.tree.map(jnp.array, params),
                             jt.make_lora_optimizer(tc, 4).init(jlora), jax.tree.map(jnp.array, jlora))
    bn = batch_np(4)
    rng = jax.random.PRNGKey(12)
    jnew, jmet = jt.make_lora_train_step(jm, tc, 4)(jstate, {k: jnp.asarray(v) for k, v in bn.items()}, rng)
    j_mu = weights.lora_from_jax(jax.tree.map(np.asarray, jnew.opt_state[0].mu))
    j_nu = weights.lora_from_jax(jax.tree.map(np.asarray, jnew.opt_state[0].nu))
    j_after = weights.lora_from_jax(jax.tree.map(np.asarray, jnew.lora))

    pm = port_model(jcfg, params)
    base = {k: v.clone() for k, v in pm.state_dict().items()}
    lora = weights.lora_from_jax(jlora)
    for f in lora.values():
        for t_ in f.values():
            t_.requires_grad_(True)
    assert sorted(lora) == sorted(pt.lora_targets(pm)) and len(lora) == 4 * TINY["cfm_dit_depth"]
    before = {n: {k: t_.detach().clone() for k, t_ in f.items()} for n, f in lora.items()}
    opt = pt.make_lora_optimizer(lora, pconfig.TrainConfig(batch_size=B, learning_rate=1e-3), 4)
    t = min(TMEL, int(2 * (TS // 2) * pm.interp_factor))
    m = pt.make_lora_train_step(pm, lora, opt)(to_torch(bn), draws=forward_draws(jax.random.fold_in(rng, 0), B, t,
                                                                                   TINY["cfm_mel_channels"]))
    assert rel(m["cfm_loss"].item(), float(jmet["cfm_loss"])) < 1e-5
    for name, f in lora.items():
        for k in ("A", "B"):
            mu, nu = (opt.inner.state[f[k]][s].numpy() for s in ("exp_avg", "exp_avg_sq"))
            assert rel(f[k].grad.numpy(), j_mu[name][k].numpy() / (1 - tc.betas[0])) < GRAD_BAR, (name, k)
            assert rel(mu, j_mu[name][k].numpy()) < UPDATE_BAR, (name, k)
            assert rel(nu, j_nu[name][k].numpy()) < UPDATE_BAR, (name, k)
        # B starts at 0: its change is its value
        assert rel((f["B"] - before[name]["B"]).detach().numpy(),
                   (j_after[name]["B"] - before[name]["B"]).numpy()) < UPDATE_BAR, name
        # A's gradient is 0 while B is 0, on both sides: its step is the weight
        # decay alone, lr * 1e-4 * A, below A's float32 resolution
        assert rel(f["A"].detach().numpy(), j_after[name]["A"].numpy()) < 1e-6, name
        assert f["B"].abs().sum() > 0 and not f["A"].grad.any()
    for k, v in pm.state_dict().items():  # the base never moves
        assert torch.equal(v, base[k]), k
    np.testing.assert_array_equal(np.asarray(jax.tree_util.tree_leaves(jnew.params)[0]),
                                  np.asarray(jax.tree_util.tree_leaves(params)[0]))
    merged = pt.merge_lora(pm.state_dict(), lora)
    j_merged = weights.s2v3_from_jax(jax.tree.map(np.asarray, jt.merge_lora(jnew.params, jnew.lora)), jcfg)
    for name in lora:
        assert rel(merged[name].numpy(), j_merged[name].numpy()) < 1e-6, name
        assert not torch.equal(merged[name], base[name])
