"""K2 (`qdense_int8`), K3 (`qkv_rope_int8`) and K4 (`qdense_out_int8`): the
port's plain twins
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
from gpt_sovits_tpu.ops.pallas.qmatmul import qdense_out_int8 as j_qdense_out
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


@pytest.mark.parametrize("b, t, q_scale", [(1, 100, 1.0), (3, 100, 0.125), (2, 200, 0.5)])
def test_qkv_rope_twin_matches_pallas_ragged_and_q_scale(b, t, q_scale):
    """K3 at row counts B x T that are no multiple of the GEMM's 128-row
    tiles (the kernel's last row block is ragged; the Pallas wrapper pads T)
    and with a static q scale, which only q takes."""
    rng = np.random.default_rng(31 + t + b)
    k, heads, dh = 128, 2, 64
    n = heads * dh
    x = rng.standard_normal((b, t, k)).astype(np.float32)
    ws = [_weights(rng, k, n) for _ in range(3)]
    with pltpu.force_tpu_interpret_mode():
        want = j_qkv(jnp.asarray(x), *[jnp.asarray(w[0]) for w in ws], *[jnp.asarray(w[1]) for w in ws],
                     *[jnp.asarray(w[2]) for w in ws], dim_head=dh, block_m=32, q_scale=q_scale)
    tw = [_torch_w(*w) for w in ws]
    args = (torch.from_numpy(x), *[w[0] for w in tw], *[w[1] for w in tw], *[w[2] for w in tw])
    got = qmatmul.qkv_rope_int8(*args, dim_head=dh, q_scale=q_scale)
    for g, w in zip(got, want):
        assert g.shape == (b, heads, t, dh)
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :, :t], **TOL)
    unscaled = qmatmul.qkv_rope_int8(*args, dim_head=dh)
    torch.testing.assert_close(got[0], unscaled[0] * q_scale, rtol=1e-6, atol=1e-6)
    for g, u in zip(got[1:], unscaled[1:]):
        torch.testing.assert_close(g, u, rtol=0, atol=0)


def test_qkv_rope_checks_dim_head_on_the_cpu():
    """An epilogue thread's 8 columns must lie in one head: dim_head % 8."""
    x = torch.zeros((1, 4, 128))
    w = (torch.zeros((132, 128), dtype=torch.int8),) * 3 + (torch.ones(132),) * 3 + (torch.zeros(132),) * 3
    with pytest.raises(ValueError, match="multiple of 128"):
        qmatmul.qkv_rope_int8(x, *w, dim_head=12)
    w = (torch.zeros((128, 128), dtype=torch.int8),) * 3 + (torch.ones(128),) * 3 + (torch.zeros(128),) * 3
    with pytest.raises(ValueError, match="multiple of 8"):
        qmatmul.qkv_rope_int8(x, *w, dim_head=4)
    with pytest.raises(ValueError, match="multiple of 8"):
        qmatmul.qkv_rope_int8(x, *w, dim_head=12)


# K4's epilogue variants: (res_gate, mask); res_gate_mask may be None, and so may its mask
@pytest.mark.parametrize("variant", ["plain", "res_gate", "res_gate_mask"])
def test_qdense_out_twin_matches_pallas(variant):
    """Heads in, at heads of very different scales (the row scale is the max
    over heads, so a head-order or layout fault moves the output)."""
    rng = np.random.default_rng({"plain": 21, "res_gate": 22, "res_gate_mask": 23}[variant])
    b, heads, t, dh, n = 2, 4, 64, 32, 128
    k = heads * dh
    attn = (rng.standard_normal((b, heads, t, dh)) * np.array([0.1, 1.0, 5.0, 0.5])[None, :, None, None])
    attn = attn.astype(np.float32)
    wq, s, bias = _weights(rng, k, n)
    res = rng.standard_normal((b, t, n)).astype(np.float32)
    gate = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([50, 64])[:, None]).astype(np.float32)
    jrg = prg = None
    if variant != "plain":
        m = mask if variant == "res_gate_mask" else None
        jrg = (jnp.asarray(res), jnp.asarray(gate), None if m is None else jnp.asarray(m))
        prg = (torch.from_numpy(res), torch.from_numpy(gate), None if m is None else torch.from_numpy(m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_qdense_out(jnp.asarray(attn), jnp.asarray(wq), jnp.asarray(s), jnp.asarray(bias),
                                       res_gate_mask=jrg, block_m=32))
    got = qmatmul.qdense_out_int8(torch.from_numpy(attn), *_torch_w(wq, s, bias), res_gate_mask=prg)
    assert got.shape == (b, t, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if variant == "res_gate_mask":  # pad rows carry the residual alone
        np.testing.assert_allclose(got.numpy()[0, 50:], res[0, 50:], rtol=0, atol=1e-6)
    # merging the heads in another order is far off
    swapped = qmatmul.qdense_out_int8(torch.from_numpy(attn[:, ::-1].copy()), *_torch_w(wq, s, bias), res_gate_mask=prg)
    assert float((swapped - got).abs().max()) > 1.0


def test_qdense_out_checks_the_layout_on_the_cpu():
    attn = torch.zeros((1, 4, 8, 32))
    w = (torch.zeros((128, 128), dtype=torch.int8), torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError, match="contiguous"):
        qmatmul.qdense_out_int8(torch.zeros((1, 8, 4, 32)).transpose(1, 2), *w)
    with pytest.raises(ValueError, match="shape"):
        qmatmul.qdense_out_int8(attn, *w, res_gate_mask=(torch.zeros((1, 8, 64)), torch.zeros((1, 128)), None))
    with pytest.raises(ValueError, match="dim_head"):
        qmatmul.qdense_out_int8(torch.zeros((1, 32, 8, 4)), *w)


def test_kernel_wrappers_take_the_twin_only_on_cpu():
    """A CPU tensor takes the twin; a device the port has no kernel for raises."""
    x = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError, match="no kernel"):
        qmatmul.qdense_int8(x.to("meta"), torch.zeros((128, 64), dtype=torch.int8), torch.ones(128), torch.zeros(128))


@pytest.mark.parametrize("m, n", [(1024, 1024), (1024, 2048), (4096, 1024), (2560, 1024), (10240, 1024),
                                  (1000, 1024), (100, 2048), (1, 128), (8 * 1024, 2048)])
def test_gemm_plan_covers_every_output_once(m, n):
    """The qdense GEMM's grid, as csrc/qmatmul.cu walks it (block (x, y):
    rows y*128.., columns x*tile_n..; rows past M are skipped), covers each
    output element exactly once, for the main path's shapes (B x 1024 rows,
    N 1024 / 2048, K4's 2560) and ragged ones."""
    tile_n, grid_m = qmatmul.gemm_plan(m, n)
    assert tile_n in qmatmul.GEMM_TILES_N and n % tile_n == 0
    hits = np.zeros((m, n), np.int32)
    for y in range(grid_m):
        for x in range(n // tile_n):
            hits[y * qmatmul.GEMM_TILE_M:(y + 1) * qmatmul.GEMM_TILE_M, x * tile_n:(x + 1) * tile_n] += 1
    assert (hits == 1).all()
    # no block lies wholly past M
    assert (grid_m - 1) * qmatmul.GEMM_TILE_M < m


def test_gemm_plan_fills_the_card_at_the_dit_shapes():
    """At B = 1 (M = 1024) every DiT projection launches at least 128
    blocks: 64-column tiles where 128-column ones would leave SMs idle;
    128-column tiles once they alone cover the 132 SMs (K4 at B = 1, every
    projection at B = 4)."""
    for n in (1024, 2048):
        tile_n, grid_m = qmatmul.gemm_plan(1024, n)
        assert tile_n == 64 and grid_m * n // tile_n >= 128
    assert qmatmul.gemm_plan(2560, 1024)[0] == 128
    for n in (1024, 2048):
        assert qmatmul.gemm_plan(4096, n)[0] == 128


@pytest.mark.parametrize("b", [1, 2, 4])
def test_gemm_plan_counts_k3s_three_projections(b):
    """K3 launches q, k and v in one grid (z = 3), so its plan takes the
    wide tile as soon as 3 x the 128-column tiles cover the 132 SMs: at
    every DiT batch, where K2's to_out at B <= 2 takes 64-column tiles."""
    m, n = b * 1024, 1024
    tile_n, grid_m = qmatmul.gemm_plan(m, n, 3)
    assert tile_n == 128 and grid_m * (n // tile_n) * 3 >= qmatmul.SMS
    assert qmatmul.gemm_plan(m, n) == ({1: 64, 2: 64, 4: 128}[b], grid_m)
    # ragged: B x T = 1000 rows still take one block per 128 rows, the last partial
    tile_n, grid_m = qmatmul.gemm_plan(1000, n, 3)
    assert grid_m == 8 and (grid_m - 1) * qmatmul.GEMM_TILE_M < 1000 <= grid_m * qmatmul.GEMM_TILE_M


def test_gemm_contract_checked_on_the_cpu():
    """K % 64, K <= 2048 and N % 128 are refused on every device."""
    x = torch.zeros((1, 4, 96))
    with pytest.raises(ValueError, match="multiple of 64"):
        qmatmul.qdense_int8(x, torch.zeros((128, 96), dtype=torch.int8), torch.ones(128), torch.zeros(128))
    x = torch.zeros((1, 4, 128))
    with pytest.raises(ValueError, match="multiple of 128"):
        qmatmul.qdense_int8(x, torch.zeros((192, 128), dtype=torch.int8), torch.ones(192), torch.zeros(192))
