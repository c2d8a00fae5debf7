"""The v3/v4 training forward (models/v3.py SynthesizerTrnV3.forward)
against the JAX package's on the CPU at tiny widths, JAX's draws fed in:
v3 on the bootstrap branch, v4 on the plain one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_v3 import (
    B, TMEL, TS, TINY, batch_np, forward_draws, key_with_boot, port_model, rel, setup, to_torch,
)
from gpt_sovits_tpu_torch.train import s2_train_v3 as pt

torch.set_num_threads(1)


@pytest.mark.parametrize("version,boot", [("v3", True), ("v4", False)])
def test_training_forward_matches_jax(version, boot):
    jcfg, jm, params = setup(version)
    bn = batch_np(1)
    key = key_with_boot(boot, split=True)
    jl = jm.apply(params, *(jnp.asarray(bn[k]) for k in pt.BATCH_KEYS), rng=key)
    pm = port_model(jcfg, params)
    tb = to_torch(bn)
    t = min(TMEL, int(2 * (TS // 2) * pm.interp_factor))
    draws = forward_draws(key, B, t, TINY["cfm_mel_channels"])
    assert pt.step_draws(pm, tb, torch.Generator().manual_seed(0))["x0"].shape == draws["x0"].shape
    with torch.no_grad():
        loss = pm(*(tb[k] for k in pt.BATCH_KEYS), draws=draws)
    assert rel(loss.item(), float(jl)) < 1e-5, (loss.item(), float(jl))
    # the port's own draws come from a CPU generator, reproducibly
    with torch.no_grad():
        a, b = (pm(*(tb[k] for k in pt.BATCH_KEYS), generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert a.item() == b.item()
