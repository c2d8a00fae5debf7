"""K6 (and K7): the port's plain twin `snake_aa_plain`
(gpt_sovits_tpu_torch/ops/snake_aa.py, what the CUDA kernel is held against
on the card) against the Pallas kernels of gpt_sovits_tpu/ops/pallas/
snake_aa.py run in interpret mode on the CPU, at the JAX tests' bar (atol
2e-5, rtol 1e-4, tests/test_snake_aa.py):

  * `snake_aa_fused` at that file's shapes, on (B, T, C), which the port
    takes as (B, C, T);
  * `snake_aa_folded` at the production plan's (r, ch, q), unfolded to
    (B, C, T);
  * T = 1, 2, 3, 6, 7 (the edges overlap) and logscale=False;
  * the wrapper's layout checks, which run on every device.

Inputs are made with numpy from a seed; alpha and beta differ per channel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt_sovits_tpu.ops.pallas import snake_aa as jsnake
from gpt_sovits_tpu_torch.ops import snake_aa

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(seed, b, t, c, amp=0.5):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, c)) * amp).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.1).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, alpha, beta


def _port(x_btc, alpha, beta, logscale=True):
    """The port on (B, C, T), returned as (B, T, C)."""
    x = torch.from_numpy(np.ascontiguousarray(x_btc.transpose(0, 2, 1)))
    y = snake_aa.snake_aa(x, torch.from_numpy(alpha), torch.from_numpy(beta), logscale=logscale)
    assert y.shape == x.shape and y.dtype == x.dtype
    return y.numpy().transpose(0, 2, 1)


def _fused(x, alpha, beta, logscale=True, tile_t=128):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jsnake.snake_aa_fused(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                                logscale=logscale, tile_t=tile_t, tile_c=min(x.shape[-1], 128)))


@pytest.mark.parametrize("t,c", [(64, 8), (200, 16), (512, 128)])
def test_twin_matches_snake_aa_fused(t, c):
    x, alpha, beta = _inputs(0, 2, t, c)
    np.testing.assert_allclose(_port(x, alpha, beta), _fused(x, alpha, beta), **TOL)


@pytest.mark.parametrize(
    "r,ch,q",
    [(1, 768, 48), (2, 192, 100), (4, 96, 96), (8, 48, 70), (16, 24, 40), (2, 64, 60), (16, 24, 33)],
)
def test_twin_matches_snake_aa_folded(r, ch, q):
    t = q * r
    x, alpha, beta = _inputs(1, 2, t, ch)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsnake.snake_aa_folded(jnp.asarray(x.reshape(2, q, r * ch)), jnp.asarray(alpha),
                                                 jnp.asarray(beta), r=r, ch=ch, logscale=True, tile_q=16))
    np.testing.assert_allclose(_port(x, alpha, beta), want.reshape(2, t, ch), **TOL)


@pytest.mark.parametrize("t", [1, 2, 3, 6, 7])
def test_twin_matches_at_overlapping_edges(t):
    x, alpha, beta = _inputs(2, 2, t, 8, amp=2.0)
    np.testing.assert_allclose(_port(x, alpha, beta), _fused(x, alpha, beta, tile_t=8), **TOL)


def test_twin_matches_without_logscale():
    x, alpha, beta = _inputs(3, 2, 96, 16)
    alpha, beta = 1.0 + np.abs(alpha), 0.5 + np.abs(beta)  # linear-scale parameters, positive
    np.testing.assert_allclose(_port(x, alpha, beta, logscale=False), _fused(x, alpha, beta, logscale=False),
                               **TOL)


def test_edges_clamp_the_snaked_stream():
    """The first and last samples equal the composition's (replicate pad of
    the snaked stream), not the interior formula carried on through
    edge-replicated x, which differs there at this amplitude."""
    x, alpha, beta = _inputs(4, 1, 40, 4, amp=8.0)
    got = _port(x, alpha, beta)
    xp = np.concatenate([np.repeat(x[:, :1], 8, 1), x, np.repeat(x[:, -1:], 8, 1)], axis=1)
    through_x = _port(xp, alpha, beta)[:, 8:-8]
    np.testing.assert_allclose(got[:, 3:-3], through_x[:, 3:-3], **TOL)
    assert np.abs(got[:, :3] - through_x[:, :3]).max() > 1e-3


def test_wrapper_checks_the_layout_on_the_cpu():
    x = torch.zeros((1, 4, 16))
    a = torch.zeros(4)
    with pytest.raises(ValueError, match="contiguous"):
        snake_aa.snake_aa(torch.zeros((1, 16, 4)).transpose(1, 2), a, a)
    with pytest.raises(ValueError, match="shape"):
        snake_aa.snake_aa(x, torch.zeros(3), a)
    with pytest.raises(ValueError, match="expected"):
        snake_aa.snake_aa(torch.zeros((4, 16)), a, a)
    with pytest.raises(ValueError, match="no kernel"):
        snake_aa.snake_aa(x.to("meta"), a, a)
    assert snake_aa.snake_aa(x.to(torch.bfloat16), a, a).dtype == torch.bfloat16
    assert snake_aa.launch_counts() == {"snake_aa": 0}  # the CPU never launches
