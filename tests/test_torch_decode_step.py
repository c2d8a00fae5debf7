"""K1, the S1 decode step: the port's plain twin
(gpt_sovits_tpu_torch/ops/decode_step.py, what the CPU runs and what the
CUDA kernels are held against on the card) vs the JAX package's Pallas
kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.ops.pallas import decode_step as jds
from gpt_sovits_tpu.utils.config import S1Config as JS1Config
from gpt_sovits_tpu_torch.ops import decode_step as pds
from gpt_sovits_tpu_torch.utils.config import S1Config
from gpt_sovits_tpu_torch.weights import s1_from_jax

torch.set_num_threads(1)

TINY = dict(
    vocab_size=41, phoneme_vocab_size=37, embedding_dim=256, hidden_dim=256,
    num_heads=8, ffn_dim=512, num_layers=3, eos_id=40, bert_dim=16, max_len=128,
)
T_PAD, N_VALID = 256, 70


@pytest.fixture(scope="module")
def params():
    m = JT2S(JS1Config(**TINY))
    return m.init(jax.random.PRNGKey(0), method=JT2S.init_all)


def _torch_weights(params, quant):
    sd = s1_from_jax(jax.tree.map(np.asarray, params), S1Config(**TINY))
    return pds.stack_weights_from_params(sd, TINY["num_layers"], quant=quant)


def _case(b, seed=0):
    rng = np.random.default_rng(seed)
    L, d = TINY["num_layers"], TINY["hidden_dim"]
    kv = (rng.standard_normal((L, b, T_PAD, 2 * d)) * 0.3).astype(np.float32)
    mask = np.zeros((b, T_PAD), np.float32)
    mask[:, :N_VALID] = 1.0
    mask[0, 5:9] = 0.0  # irregular hole (left-padding pattern)
    x = (rng.standard_normal((b, d)) * 0.5).astype(np.float32)
    return x, kv, mask


def _both(params, b, quant):
    x, kv, mask = _case(b)
    jw = jds.stack_weights_from_params(params, TINY["num_layers"], quant=quant)
    with pltpu.force_tpu_interpret_mode():
        yj, kvj = jds.fused_decode_step(
            jnp.asarray(x), jw, jnp.asarray(kv).astype(jnp.bfloat16), jnp.asarray(mask), jnp.asarray(N_VALID),
            chunk=128, num_heads=TINY["num_heads"],
        )
    pw = _torch_weights(params, quant)
    kvp = torch.from_numpy(kv).to(torch.bfloat16)
    yp, kvp = pds.fused_decode_step(
        torch.from_numpy(x), pw, kvp, torch.from_numpy(mask), N_VALID, num_heads=TINY["num_heads"]
    )
    return (np.asarray(yj), np.asarray(kvj, np.float32)), (yp.numpy(), kvp.float().numpy())


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("b", [1, 2])
def test_step_matches_pallas(params, b, quant):
    """Bars of test_decode_step_kernel.py:68-83: new K/V 2e-2, logits 5e-2,
    logit correlation > 0.9999. Both sides run bf16 (or s8) operands with
    f32 sums, in different orders. The Pallas chunk (a VMEM choice) is set
    so the live prefix is one chunk, as in the twin: in W8A8 mode the JAX
    kernel alone moves the new K/V by ~0.05 between chunk 64 and 128, since
    a softmax rounding change flips activation codes in later layers."""
    (yj, kvj), (yp, kvp) = _both(params, b, quant)
    np.testing.assert_allclose(kvp[:, :, N_VALID], kvj[:, :, N_VALID], atol=2e-2, rtol=2e-2)
    # the rest of the cache is untouched
    np.testing.assert_array_equal(np.delete(kvp, N_VALID, axis=2), np.delete(kvj, N_VALID, axis=2))
    head = np.asarray(params["params"]["predict"]["kernel"])
    lj, lp = yj @ head, yp @ head
    np.testing.assert_allclose(lp, lj, atol=5e-2, rtol=5e-2)
    assert np.corrcoef(lp.ravel(), lj.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("b", [1, 2])
def test_int8_kv_close_to_bf16(params, b):
    """int8 KV: the probability scale is taken per split here and per VMEM
    chunk on the TPU, so bit equality is impossible; the JAX tests' bar
    (test_decode_step_kernel.py:179-182) is rel < 0.02 against bf16 KV.
    Held for the port against the Pallas bf16 output, and the Pallas int8
    output against the same bar, plus the quantized write-back."""
    x, kv, mask = _case(b, seed=1)
    jw = jds.stack_weights_from_params(params, TINY["num_layers"])
    with pltpu.force_tpu_interpret_mode():
        y_ref, _ = jds.fused_decode_step(
            jnp.asarray(x), jw, jnp.asarray(kv).astype(jnp.bfloat16), jnp.asarray(mask), N_VALID, chunk=128,
            num_heads=TINY["num_heads"],
        )
    y_ref = np.asarray(y_ref)
    pw = _torch_weights(params, "bf16")
    kq, sc = pds.quantize_kv_cache(torch.from_numpy(kv))
    yp, kq2, sc2 = pds.fused_decode_step(torch.from_numpy(x), pw, kq, torch.from_numpy(mask), N_VALID, sc,
                                         num_heads=TINY["num_heads"])
    rel = np.abs(yp.numpy() - y_ref).mean() / (np.abs(y_ref).mean() + 1e-9)
    assert rel < 0.02, rel
    # write-back: dequantized new slot == the bf16 path's new K/V (the JAX
    # test's bar, rtol 0.05 / atol 0.02)
    _, kvb = pds.fused_decode_step(torch.from_numpy(x), pw, torch.from_numpy(kv).to(torch.bfloat16),
                                   torch.from_numpy(mask), N_VALID, num_heads=TINY["num_heads"])
    d = TINY["hidden_dim"]
    new_q = kq2[:, :, N_VALID].float().numpy()
    deq = np.concatenate([new_q[..., :d] * sc2[:, :, 0, N_VALID, None].numpy(),
                          new_q[..., d:] * sc2[:, :, 1, N_VALID, None].numpy()], -1)
    np.testing.assert_allclose(deq, kvb[:, :, N_VALID].float().numpy(), rtol=0.05, atol=0.02)


def test_quantizers_exactly_equal():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 8, 16)).astype(np.float32)
    qj, sj = jds._quantize_cols(jnp.asarray(w))
    qp, sp = pds._quantize_cols(torch.from_numpy(w))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    kv = (rng.standard_normal((2, 3, 20, 64)) * 0.7).astype(np.float32)
    cj, scj = jds.quantize_kv_cache(jnp.asarray(kv))
    cp, scp = pds.quantize_kv_cache(torch.from_numpy(kv))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(scp.numpy(), np.asarray(scj))


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_stacked_weights_equal(params, quant):
    jw = jds.stack_weights_from_params(params, TINY["num_layers"], quant=quant)
    pw = _torch_weights(params, quant)
    assert set(jw) == set(pw)
    for k in jw:
        np.testing.assert_array_equal(pw[k].float().numpy(), np.asarray(jw[k], np.float32), err_msg=k)


def test_wrappers_route_by_device():
    """CPU tensors take the plain twin; any other device is refused (a CUDA
    tensor launches the kernel, which only the card can run)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.zeros(128)
    before = pds.launch_counts()
    torch.testing.assert_close(pds.proj(x, w, bias, relu=True), pds.proj_plain(x, w, bias, relu=True), rtol=0, atol=0)
    assert pds.launch_counts() == before  # the plain twin is not a kernel launch
    with pytest.raises(ValueError, match="no kernel"):
        pds.proj(x.to("meta"), w.to("meta"), bias.to("meta"))
