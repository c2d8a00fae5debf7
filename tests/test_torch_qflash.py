"""K5 (`flash_attn_int8`): the port's plain twin (gpt_sovits_tpu_torch/ops/
qflash.py, what the CUDA kernels are held against on the card) against the
Pallas kernel of gpt_sovits_tpu/ops/pallas/qflash.py in interpret mode on
the CPU, at the JAX tests' bars (rtol 4e-2 / atol 3e-2, tests/test_qflash.py;
a peaked case at 8e-2 / 6e-2 as there). A T that the Pallas wrapper rejects
is held against the f32 einsum reference instead. Inputs from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt_sovits_tpu.ops.pallas.qflash import flash_attn_int8 as j_flash
from gpt_sovits_tpu_torch.ops.qflash import flash_attn_int8

torch.set_num_threads(1)


def _qkv(b, h, t, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(3)]


def _einsum_ref(q, k, v, mask, sm):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * sm
    if mask is not None:
        s = np.where(mask[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bhkd->bhqd", p, v)
    b, h, t, dh = o.shape
    return o.transpose(0, 2, 1, 3).reshape(b, t, h * dh)


def _both(q, k, v, mask=None, dtype=jnp.float32):
    sm = 1.0 / float(np.sqrt(q.shape[-1]))
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_flash(jq, jk, jv, None if mask is None else jnp.asarray(mask), sm_scale=sm), np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    pq, pk, pv = (torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in (jq, jk, jv))
    got = flash_attn_int8(pq, pk, pv, None if mask is None else torch.from_numpy(mask.astype(np.float32)), sm_scale=sm)
    assert got.dtype == tdt
    return got.float().numpy(), want


@pytest.mark.parametrize("shape", [(2, 2, 256, 64), (1, 4, 512, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_twin_matches_pallas(shape, dtype):
    got, want = _both(*_qkv(*shape, seed=0), dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    b, h, t, dh = shape
    assert got.shape == (b, t, h * dh)
    tol = 4e-2 if dtype == "f32" else 7e-2  # bf16 inputs: the JAX test's bar for them
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_twin_key_mask_and_odd_heads():
    lens = np.array([256, 131])
    mask = np.arange(256)[None, :] < lens[:, None]
    q, k, v = _qkv(2, 3, 256, 64, seed=1)
    # keys planted in the pad region that would dominate every row if the
    # mask were ignored
    k[1, :, 131:] = 4.0 * q[1, :, :1]
    v[1, :, 131:] = 8.0
    got, want = _both(q, k, v, mask)
    for i, ln in enumerate(lens):  # real query rows (pad rows are the caller's to mask)
        np.testing.assert_allclose(got[i, :ln], want[i, :ln], rtol=4e-2, atol=3e-2)
    np.testing.assert_allclose(got[1, :131], _einsum_ref(q, k, v, mask, 0.125)[1, :131], rtol=4e-2, atol=3e-2)


def test_twin_peaked_rows():
    q, k, v = _qkv(1, 2, 256, 64, seed=3)
    got, want = _both(q * 4.0, k, v)
    np.testing.assert_allclose(got, want, rtol=8e-2, atol=6e-2)


def test_twin_cpu_chunk_length():
    """T = 1000, the CPU chunk (the Pallas wrapper takes it as one block)."""
    t = 1000
    q, k, v = _qkv(1, 1, t, 64, seed=t)
    mask = np.arange(t)[None, :] < t - 40
    got, want = _both(q, k, v, mask)
    np.testing.assert_allclose(got[0, : t - 40], want[0, : t - 40], rtol=4e-2, atol=3e-2)


def test_twin_takes_a_t_pallas_rejects():
    """T = 1536: the Pallas wrapper rejects it (T % block_q); the twin takes
    it and is held against the f32 einsum reference."""
    t = 1536
    q, k, v = _qkv(1, 1, t, 64, seed=t)
    mask = np.arange(t)[None, :] < t - 40
    with pytest.raises(ValueError, match="multiple of block_q"), pltpu.force_tpu_interpret_mode():
        j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), sm_scale=0.125)
    got = flash_attn_int8(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask.astype(np.float32)),
                          sm_scale=0.125).numpy()
    ref = _einsum_ref(q, k, v, mask, 0.125)[0, : t - 40]
    # three times the keys of the JAX tests' largest T: the codes e8 of a
    # near-uniform row are ~3x smaller, so one element in ~1e5 reaches 0.033;
    # the bar is the JAX tests' rtol with atol 5e-2, and the mean error must
    # stay at the int8 rounding level
    np.testing.assert_allclose(got[0, : t - 40], ref, rtol=4e-2, atol=5e-2)
    assert np.abs(got[0, : t - 40] - ref).mean() < 5e-3
