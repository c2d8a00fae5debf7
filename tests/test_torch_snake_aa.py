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


# ---------------------------------------------------------------------------
# what the CUDA kernel takes from Python: its tile plan and its sine
# ---------------------------------------------------------------------------

# the six BigVGAN stage shapes of a 2224-frame mel (chip_smoke.V3_STAGES)
STAGES = [(768, 8896), (384, 35584), (192, 71168), (96, 142336), (48, 284672), (24, 569344)]
PLAN_SHAPES = [(3, t) for t in range(1, 21)] + [(5, 8897), (2, 1919), (2, 1920), (2, 1927), (7, 7213)] + STAGES


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,t", PLAN_SHAPES)
def test_plan_covers_every_output_once(c, t, element_size):
    """snake_plan / lane_chunks, as the kernel computes them: the storing
    threads of a row's blocks write every position of [0, T) exactly once;
    a chunk takes the 16-byte path only where it lies inside the row on a
    16-byte boundary; and the scalar path takes exactly the positions that
    no such chunk holds: the row's first `head` positions before its first
    16-byte boundary, and its last T - head mod 8 ones. A row's chunks
    depend only on its start's offset from a 16-byte boundary, so the rows
    0..vec-1 stand for all of them."""
    plan = snake_aa.snake_plan(c, t, element_size)
    assert plan.grid == c * plan.tiles and plan.threads == snake_aa.THREADS and plan.outputs == snake_aa.OUTPUTS == 8
    vec, r = plan.vec, plan.outputs
    for row in range(min(c, vec)):
        lanes = np.array(snake_aa.lane_chunks(plan, t, row))
        start, stores, vector = lanes[:, 0], lanes[:, 1].astype(bool), lanes[:, 2].astype(bool)
        pos = start[stores, None] + np.arange(r)[None]
        written = pos[(pos >= 0) & (pos < t)]
        np.testing.assert_array_equal(np.sort(written), np.arange(t))  # every output exactly once
        assert ((row * t + start[vector]) * element_size % 16 == 0).all()  # 16-byte accesses are aligned
        np.testing.assert_array_equal(vector, (start >= 0) & (start + r <= t))
        head = (-(row * t) * element_size % 16) // element_size  # positions before the first boundary
        body = max(t - head, 0) // r * r
        scalar = pos[~vector[stores]]
        scalar = np.sort(scalar[(scalar >= 0) & (scalar < t)])
        want = np.concatenate([np.arange(min(head, t)), np.arange(head + body, t) if t > head else []])
        np.testing.assert_array_equal(scalar, want)


def _fma(a, b, c):
    """fmaf emulated: the exact product of two float32 in float64, plus c,
    rounded to float32 (a second rounding, which can differ from one fused
    rounding in the last bit)."""
    return (np.float64(1) * a * b + c).astype(np.float32)


def _kernel_sin2(z):
    """csrc/snake_aa.cu sin2() on float32 z, step by step."""
    z = np.asarray(z, np.float32)
    p0, p1, p2 = snake_aa.pi_parts()
    k = np.rint((z * snake_aa.INV_PI).astype(np.float32))
    r = _fma(-k, p0, z)
    r = _fma(-k, p1, r)
    r = _fma(-k, p2, r)
    w = (r * r).astype(np.float32)
    c = snake_aa.sin2_coefficients()
    p = np.full_like(w, c[-1])
    for ci in c[-2::-1]:
        p = _fma(p, w, ci)
    return (w * p).astype(np.float32), r


@pytest.mark.parametrize("zmax", [10.0, 1e4, snake_aa.SIN2_ZMAX])
def test_kernel_sine_within_its_bound(zmax):
    """The kernel's sin^2 (Cody-Waite reduction by pi, r^2 P(r^2)), in the
    same float32 arithmetic, against float64 sin^2 of the same float32 z:
    within SIN2_MAX_ABS_ERR over |z| <= zmax, random z and z next to every
    multiple of pi there (where the reduction cancels most), and its
    reduced argument within the polynomial's fitted range."""
    rng = np.random.default_rng(0)
    k = np.arange(-int(zmax / np.pi), int(zmax / np.pi) + 1)
    z = np.concatenate([rng.uniform(-zmax, zmax, 400_000), k * np.pi, k * np.pi + np.pi / 2]).astype(np.float32)
    z = z[np.abs(z) <= zmax]
    got, r = _kernel_sin2(z)
    err = np.abs(got.astype(np.float64) - np.sin(z.astype(np.float64)) ** 2)
    assert err.max() <= snake_aa.SIN2_MAX_ABS_ERR, err.max()
    assert np.abs(r).max() <= snake_aa.SIN2_R


def test_sine_constants():
    """pi's parts sum to pi far below float32's step, and P starts at 1 (sin r ~ r)."""
    p = snake_aa.pi_parts().astype(np.float64)
    assert abs(p.sum() - np.pi) < 1e-15 and abs(p[0] - np.pi) < 2e-7
    c = snake_aa.sin2_coefficients()
    assert c.dtype == np.float32 and len(c) == snake_aa.SIN2_TERMS and abs(c[0] - 1) < 1e-6 and abs(c[1] + 1 / 3) < 1e-5
