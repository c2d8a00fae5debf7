"""The port's DiT (gpt_sovits_tpu_torch/models/dit.py) against the JAX
package's (gpt_sovits_tpu/models/dit.py) at a tiny size, same weights
(numpy, seeded) and inputs:

  * the float DiT (f32, quant "bf16": the einsum attention path of both);
  * the int8 DiT: the port's fused chain on its plain twins (K3 -> K5 -> K2,
    what the CUDA kernels are held against on the card) against the JAX
    fused chain that the TPU runs, dit.py:364-457 through the Pallas kernels
    in interpret mode (the backend reported as "tpu" inside
    pltpu.force_tpu_interpret_mode(), T = 512); bar: mean relative error
    <= 0.01 over real frames (the JAX fused and XLA int8 paths differ by
    ~0.002 there);
  * quantize_dit_params: int8 codes and f32 scales equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt_sovits_tpu.models.dit import DiT as JDiT
from gpt_sovits_tpu.models.dit import DiTConfig as JCfg
from gpt_sovits_tpu.models.dit import quantize_dit_params as j_quantize
from gpt_sovits_tpu_torch.models.dit import DiT, DiTConfig, quantize_dit_params, serving_dit
from gpt_sovits_tpu_torch.weights import dit_from_jax

torch.set_num_threads(1)
CFG = dict(dim=128, depth=2, heads=4, dim_head=32, ff_mult=2, mel_dim=20, text_dim=64, conv_layers=2)
B, T = 2, 512
LENS = np.array([T, 400])


def _params(seed=0):
    jd = JDiT(JCfg(**CFG))
    x = jnp.zeros((1, 16, CFG["mel_dim"]))
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), x, x, jnp.zeros(1), jnp.zeros(1),
                                            jnp.zeros((1, 16, CFG["text_dim"]))))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, CFG["mel_dim"])).astype(np.float32)
    cond = (0.5 * rng.standard_normal((B, T, CFG["mel_dim"]))).astype(np.float32)
    text = (0.5 * rng.standard_normal((B, T, CFG["text_dim"]))).astype(np.float32)
    t = np.array([0.25, 0.7], np.float32)
    dt = np.full((B,), 1 / 32, np.float32)
    mask = np.arange(T)[None, :] < LENS[:, None]
    return x, cond, t, dt, text, mask


def _port(params, quant="bf16"):
    sd = dit_from_jax(params, DiTConfig(**CFG))
    if quant == "int8":
        return serving_dit(sd, DiTConfig(**CFG), torch.float32, "int8")
    dit = DiT(DiTConfig(**CFG))
    dit.load_state_dict(sd, strict=True)
    return dit.eval()


def _run_port(dit, inputs):
    x, cond, t, dt, text, mask = (torch.from_numpy(np.asarray(a)) for a in inputs)
    with torch.no_grad():
        out, emb = dit(x, cond, t, dt, text, mask)
    return out.numpy(), emb.numpy()


def _rel_real(got, want):
    errs = [np.abs(got[i, :n] - want[i, :n]).mean() / np.abs(want[i, :n]).mean() for i, n in enumerate(LENS)]
    return max(errs)


@pytest.fixture(scope="module")
def params():
    return _params()


def test_float_dit_matches_jax(params):
    inputs = _inputs()
    want, want_emb = JDiT(JCfg(**CFG)).apply(params, *(jnp.asarray(a) for a in inputs))
    got, got_emb = _run_port(_port(params), inputs)
    assert got.shape == (B, T, CFG["mel_dim"])
    # f32 on both sides, other summation orders (amplified through the
    # blocks: random weights give outputs of ~50): within 1e-3 of the
    # output's scale, and a mean relative error below 1e-4
    want = np.asarray(want)
    for i, n in enumerate(LENS):
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=1e-3, atol=1e-3 * np.abs(want).max())
    assert _rel_real(got, want) < 1e-4
    np.testing.assert_allclose(got_emb, np.asarray(want_emb), rtol=1e-3, atol=1e-3 * np.abs(want_emb).max())


def test_text_embed_cache_reused(params):
    inputs = _inputs(seed=2)
    dit = _port(params)
    full, emb = _run_port(dit, inputs)
    x, cond, t, dt, text, mask = (torch.from_numpy(np.asarray(a)) for a in inputs)
    with torch.no_grad():
        cached, emb2 = dit(x, cond, t, dt, torch.zeros_like(text), mask, text_embed_cache=torch.from_numpy(emb))
    np.testing.assert_array_equal(cached.numpy(), full)
    np.testing.assert_array_equal(emb2.numpy(), emb)


def test_int8_dit_matches_jax_fused_chain(params, monkeypatch):
    inputs = _inputs(seed=3)
    jq = JDiT(JCfg(**CFG, quant="int8"))
    qparams = j_quantize(params)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want, _ = jq.apply(qparams, *(jnp.asarray(a) for a in inputs))
    monkeypatch.undo()
    got, _ = _run_port(_port(params, "int8"), inputs)
    want = np.asarray(want)
    rel = _rel_real(got, want)
    print("int8 DiT vs the JAX fused chain, mean relative error over real frames:", rel)
    assert rel <= 0.01, rel
    # and int8 is not the float path: the quantization moves the output
    ref, _ = _run_port(_port(params), inputs)
    assert _rel_real(got, ref) > 1e-4


def test_int8_dit_raises_beyond_k2_k5(params):
    """T > 2048 takes K4 in the JAX package, which is not ported."""
    dit = _port(params, "int8")
    t = 2049
    z = torch.zeros((1, t, CFG["mel_dim"]))
    with pytest.raises(NotImplementedError, match="K4"):
        dit(z, z, torch.zeros(1), torch.zeros(1), torch.zeros((1, t, CFG["text_dim"])),
            torch.ones((1, t), dtype=torch.bool))


def test_quantize_dit_params_equals_jax(params):
    jq = jax.tree.map(np.asarray, j_quantize(jax.tree.map(jnp.asarray, params)))
    sd = quantize_dit_params(dit_from_jax(params, DiTConfig(**CFG)))
    names = {"to_q": "attn.to_q", "to_k": "attn.to_k", "to_v": "attn.to_v", "to_out": "attn.to_out.0",
             "ff1": "ff.ff.0.0", "ff2": "ff.ff.2"}
    n_checked = 0
    for i in range(CFG["depth"]):
        blk = jq["params"][f"block_{i}"]
        for jname, pname in names.items():
            w, s = sd[f"transformer_blocks.{i}.{pname}.weight"], sd[f"transformer_blocks.{i}.{pname}.weight_scale"]
            assert w.dtype == torch.int8 and s.dtype == torch.float32
            np.testing.assert_array_equal(w.numpy(), blk[jname]["kernel"].T)
            np.testing.assert_array_equal(s.numpy(), blk[jname]["kernel_scale"][0])
            n_checked += 1
    assert n_checked == 6 * CFG["depth"]
    # every other entry passes through untouched
    assert sd["proj_out.weight"].dtype == torch.float32


def test_serving_dit_keeps_scales_f32_under_bf16(params):
    dit = serving_dit(dit_from_jax(params, DiTConfig(**CFG)), DiTConfig(**CFG), torch.bfloat16, "int8")
    q = dit.transformer_blocks[0].attn.to_q
    assert q.weight.dtype == torch.int8 and q.weight_scale.dtype == torch.float32 and q.bias.dtype == torch.float32
    assert dit.proj_out.weight.dtype == torch.bfloat16
    ref = j_quantize(jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params))
    np.testing.assert_array_equal(q.weight_scale.numpy(),
                                  np.asarray(ref["params"]["block_0"]["to_q"]["kernel_scale"], np.float32)[0])
    assert dataclasses.replace(dit.cfg, quant="bf16") == DiTConfig(**CFG)
