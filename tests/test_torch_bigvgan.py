"""The port's BigVGAN (gpt_sovits_tpu_torch/models/bigvgan.py) against the
JAX package's at a tiny size (32 initial channels, rates (4, 2), kernels
(8, 4), two resblock kernels), same weights (numpy, seeded) and mel:

  * f32 against `BigVGAN.apply` and against the route the JAX pipeline
    serves, `folded_bigvgan.bigvgan_apply(fold_bigvgan_params(...))`: atol
    1e-4 (other summation orders through the convolutions and 9
    anti-aliased snakes; measured 4e-7);
  * bf16 (the module and the mel cast, as the pipeline serves with half)
    against the folded route in bf16: within 0.03 at every sample and 0.005
    on average, on outputs of mean magnitude 0.16 (each layer rounds its
    output to bf16 in other places on each side; measured 0.007 and 0.0015,
    as far as the JAX bf16 route is from its own f32 output);
  * `bigvgan_from_jax` names: the state dict read back by the JAX package's
    `params_from_torch` (models/bigvgan.py:202) gives the original tree,
    tensor for tensor.

The snake's own kernel-vs-twin tests are tests/test_torch_snake_aa.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.models.bigvgan import BigVGAN as JBigVGAN
from gpt_sovits_tpu.models.bigvgan import BigVGANConfig as JCfg
from gpt_sovits_tpu.models.bigvgan import params_from_torch
from gpt_sovits_tpu.ops.folded_bigvgan import bigvgan_apply, fold_bigvgan_params
from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.weights import bigvgan_from_jax

torch.set_num_threads(1)
CFG = dict(num_mels=20, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
           resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)))
T = 40


@pytest.fixture(scope="module")
def setup():
    jm = JBigVGAN(JCfg(**CFG))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, CFG["num_mels"]))))
    rng = np.random.default_rng(0)

    def draw(path, s):
        # per-channel snake parameters that differ; kernels of unit gain, so
        # that the clamped output is not saturated
        name = str(path[-1])
        std = 0.3 if ("alpha" in name or "beta" in name) else 0.05
        if "kernel" in name:
            std = 0.7 / np.sqrt(np.prod(s.shape[:-1]))
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    mel = (rng.standard_normal((2, T, CFG["num_mels"])) * 2.0).astype(np.float32)
    pm = BigVGAN(BigVGANConfig(**CFG)).eval()
    pm.load_state_dict(bigvgan_from_jax(params, pm.cfg), strict=True)
    return jm, params, mel, pm


def _port(pm, mel, dtype=torch.float32):
    with torch.no_grad():
        return pm.to(dtype)(torch.from_numpy(mel).to(dtype)).float().numpy()


def test_matches_bigvgan_apply(setup):
    jm, params, mel, pm = setup
    want = np.asarray(jm.apply(params, jnp.asarray(mel)))
    got = _port(pm, mel)
    assert got.shape == want.shape == (2, T * 8, 1)
    assert 0.05 < np.abs(want).mean() and np.abs(want).max() <= 1.0
    assert np.mean(np.abs(want) == 1.0) < 0.1  # not saturated
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_matches_the_folded_serving_route(setup):
    _, params, mel, pm = setup
    want = np.asarray(bigvgan_apply(fold_bigvgan_params(params["params"], JCfg(**CFG)), jnp.asarray(mel)))
    np.testing.assert_allclose(_port(pm, mel), want, rtol=0, atol=1e-4)


def test_bf16_against_the_folded_route_in_bf16(setup):
    _, params, mel, pm = setup
    folded = fold_bigvgan_params(params["params"], JCfg(**CFG), dtype=jnp.bfloat16)
    want = np.asarray(bigvgan_apply(folded, jnp.asarray(mel).astype(jnp.bfloat16)), np.float32)
    pm16 = BigVGAN(BigVGANConfig(**CFG)).eval()
    pm16.load_state_dict(pm.state_dict(), strict=True)
    got = _port(pm16, mel, torch.bfloat16)
    err = np.abs(got - want)
    assert err.max() <= 0.03 and err.mean() <= 0.005, (err.max(), err.mean())


def test_bigvgan_from_jax_names_read_back(setup):
    _, params, _, pm = setup
    sd = bigvgan_from_jax(params, pm.cfg)
    assert set(sd) == set(pm.state_dict())
    back = params_from_torch(sd, JCfg(**CFG))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(flat_back) == set(flat) and len(flat) == len(sd)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))
