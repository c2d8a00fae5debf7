"""K2 (`qdense_int8`) and K3 (`qkv_rope_int8`): the port's plain twins
(gpt_sovits_tpu_torch/ops/qmatmul.py, what the CUDA kernels are held against
on the card) against the Pallas kernels of gpt_sovits_tpu/ops/pallas/
qmatmul.py run in interpret mode on the CPU, at the JAX tests' bar
(rtol = atol = 2e-2, tests/test_qmatmul.py). Inputs are made with numpy from
a seed; weights are int8 with per-output-channel scales, passed to JAX as
(K, N) and to the port in PyTorch's Linear layout (N, K)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt_sovits_tpu.ops.pallas.qmatmul import qdense_int8 as j_qdense
from gpt_sovits_tpu.ops.pallas.qmatmul import qkv_rope_int8 as j_qkv
from gpt_sovits_tpu_torch.ops import qmatmul

torch.set_num_threads(1)
TOL = dict(rtol=2e-2, atol=2e-2)


def _weights(rng, k, n):
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    s = np.maximum(np.abs(w).max(axis=0, keepdims=True) / 127.0, 1e-12).astype(np.float32)
    wq = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    bias = rng.standard_normal(n).astype(np.float32)
    return wq, s, bias


def _torch_w(wq, s, bias):
    return torch.from_numpy(np.ascontiguousarray(wq.T)), torch.from_numpy(s[0]), torch.from_numpy(bias)


# glue variants: (ln_mod, act, res_gate, mask)
VARIANTS = {
    "plain": (False, None, False, False),
    "ln_mod_gelu": (True, "gelu", False, False),
    "res_gate": (False, None, True, False),
    "mask_res_gate": (False, None, True, True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("t", [128, 100])  # 100: a T that no block divides (the Pallas wrapper pads it)
def test_qdense_twin_matches_pallas(variant, t):
    ln, act, rg, masked = VARIANTS[variant]
    rng = np.random.default_rng(hash((variant, t)) % 2**32)
    b, k, n = 2, 128, 256
    x = rng.standard_normal((b, t, k)).astype(np.float32)
    wq, s, bias = _weights(rng, k, n)
    sc = (rng.standard_normal((b, k)) * 0.3).astype(np.float32)
    sh = (rng.standard_normal((b, k)) * 0.3).astype(np.float32)
    res = rng.standard_normal((b, t, n)).astype(np.float32)
    gate = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([t, t - 37])[:, None]).astype(np.float32)
    jkw, pkw = {}, {}
    if ln:
        jkw["ln_mod"] = (jnp.asarray(sc), jnp.asarray(sh))
        pkw["ln_mod"] = (torch.from_numpy(sc), torch.from_numpy(sh))
    if rg:
        jkw["res_gate"] = (jnp.asarray(res), jnp.asarray(gate))
        pkw["res_gate"] = (torch.from_numpy(res), torch.from_numpy(gate))
    if masked:
        jkw["mask"] = jnp.asarray(mask)
        pkw["mask"] = torch.from_numpy(mask)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_qdense(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s), jnp.asarray(bias),
                                   act=act, block_m=64, **jkw))
    got = qmatmul.qdense_int8(torch.from_numpy(x), *_torch_w(wq, s, bias), act=act, **pkw)
    assert got.shape == (b, t, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if masked:  # pad rows carry the residual alone
        np.testing.assert_allclose(got.numpy()[1, t - 37 :], res[1, t - 37 :], rtol=0, atol=1e-6)


def test_qdense_twin_bf16_and_2d():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((96, 128)).astype(np.float32)
    wq, s, bias = _weights(rng, 128, 128)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_qdense(xb, jnp.asarray(wq), jnp.asarray(s), jnp.asarray(bias), block_m=32), np.float32)
    got = qmatmul.qdense_int8(torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16), *_torch_w(wq, s, bias))
    assert got.shape == (96, 128) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)


@pytest.mark.parametrize("ln", [False, True])
def test_qkv_rope_twin_matches_pallas(ln):
    rng = np.random.default_rng(11 + ln)
    b, t, k, heads, dh = 2, 96, 128, 2, 64
    n = heads * dh
    x = rng.standard_normal((b, t, k)).astype(np.float32)
    ws = [_weights(rng, k, n) for _ in range(3)]
    sc = (rng.standard_normal((b, k)) * 0.3).astype(np.float32)
    sh = (rng.standard_normal((b, k)) * 0.3).astype(np.float32)
    jln = (jnp.asarray(sc), jnp.asarray(sh)) if ln else None
    pln = (torch.from_numpy(sc), torch.from_numpy(sh)) if ln else None
    with pltpu.force_tpu_interpret_mode():
        want = j_qkv(jnp.asarray(x), *[jnp.asarray(w[0]) for w in ws], *[jnp.asarray(w[1]) for w in ws],
                     *[jnp.asarray(w[2]) for w in ws], ln_mod=jln, dim_head=dh, block_m=32)
    tw = [_torch_w(*w) for w in ws]
    got = qmatmul.qkv_rope_int8(torch.from_numpy(x), *[w[0] for w in tw], *[w[1] for w in tw],
                                *[w[2] for w in tw], ln_mod=pln, dim_head=dh)
    for g, w in zip(got, want):
        assert g.shape == (b, heads, t, dh)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # head 0 of q is rotated, the other heads are not: at positions far from
    # 0 the rotation moves head 0 by far more than the bar
    flat = got[0].permute(0, 2, 1, 3).reshape(b, t, n)
    q_plain = qmatmul.qdense_int8(torch.from_numpy(x), *tw[0], ln_mod=pln)
    np.testing.assert_allclose(flat[..., dh:].numpy(), q_plain[..., dh:].numpy(), rtol=0, atol=1e-5)
    assert float((flat[:, 50:, :dh] - q_plain[:, 50:, :dh]).abs().max()) > 0.1


def test_kernel_wrappers_take_the_twin_only_on_cpu():
    """A CPU tensor takes the twin; a device the port has no kernel for raises."""
    x = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError, match="no kernel"):
        qmatmul.qdense_int8(x.to("meta"), torch.zeros((128, 64), dtype=torch.int8), torch.ones(128), torch.zeros(128))
