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


MATS = ("wqkv", "wo", "fc1", "fc2")


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_stacked_weights_equal(params, quant):
    """The same values as the JAX package's stack: its (L, Din, Dout)
    matrices are the port's K-major (L, Dout, Din) ones, taken out of the
    kernel's fragment order, transposed."""
    jw = jds.stack_weights_from_params(params, TINY["num_layers"], quant=quant)
    pw = _torch_weights(params, quant)
    assert set(jw) == set(pw)
    for k in jw:
        got = pds.from_fragment_order(pw[k]).transpose(1, 2) if k in MATS else pw[k]
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(jw[k], np.float32), err_msg=k)


def test_wrappers_route_by_device(params):
    """The step's wrapper routes by the tensors' device with a per-row
    write_idx too: CPU tensors take the plain twin, bit for bit, with no
    launch counted (the only kernel counted is the whole step); a device
    with no kernel (meta) is refused (a CUDA tensor launches the kernel,
    which only the card can run)."""
    x, kv, mask = _case(2, seed=2)
    pw = _torch_weights(params, "int8")
    kq, sc = pds.quantize_kv_cache(torch.from_numpy(kv))
    widx = torch.tensor([N_VALID, N_VALID - 9])
    assert set(pds.launch_counts()) == {"fused_decode_step"}
    before = pds.launch_counts()
    got = pds.fused_decode_step(torch.from_numpy(x), pw, kq.clone(), torch.from_numpy(mask), widx, sc.clone(),
                                num_heads=TINY["num_heads"])
    ref = pds.fused_decode_step_plain(torch.from_numpy(x), pw, kq.clone(), torch.from_numpy(mask), widx, sc.clone(),
                                      num_heads=TINY["num_heads"])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert pds.launch_counts() == before  # the plain twin is not a kernel launch
    meta = {k: v.to("meta") for k, v in pw.items()}
    with pytest.raises(ValueError, match="no kernel"):
        pds.fused_decode_step(torch.from_numpy(x).to("meta"), meta, kq.to("meta"), torch.from_numpy(mask).to("meta"),
                              widx, sc.to("meta"), num_heads=TINY["num_heads"])


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_step_routes_by_device(params, quant):
    """The whole step on CPU tensors is its plain twin, bit for bit, with no
    launch counted; a device with no kernel (meta) is refused."""
    x, kv, mask = _case(2, seed=4)
    pw = _torch_weights(params, quant)
    before = pds.launch_counts()
    args = (torch.from_numpy(x), pw)
    y, kv_y = pds.fused_decode_step(*args, torch.from_numpy(kv).to(torch.bfloat16), torch.from_numpy(mask), N_VALID,
                                    num_heads=TINY["num_heads"])
    y_ref, kv_ref = pds.fused_decode_step_plain(*args, torch.from_numpy(kv).to(torch.bfloat16),
                                                torch.from_numpy(mask), N_VALID, num_heads=TINY["num_heads"])
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(kv_y, kv_ref, rtol=0, atol=0)
    assert pds.launch_counts() == before
    meta = {k: v.to("meta") for k, v in pw.items()}
    with pytest.raises(ValueError, match="no kernel"):
        pds.fused_decode_step(args[0].to("meta"), meta, kv_y.to("meta"), torch.from_numpy(mask).to("meta"), N_VALID,
                              num_heads=TINY["num_heads"])


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_stacked_matrices_are_k_major(params, quant):
    """Each layer's stacked matrix, out of the fragment order, is the state
    dict's Linear weight (N, K): bf16-rounded, or int8 codes whose per-row
    scale brings them back within half a step; the round trip from the JAX
    tree through s1_from_jax is unchanged. The stack is contiguous, as the
    step kernel streams it."""
    sd = s1_from_jax(jax.tree.map(np.asarray, params), S1Config(**TINY))
    pw = _torch_weights(params, quant)
    assert all(pw[k].is_contiguous() for k in MATS)
    pw = {**pw, **{k: pds.from_fragment_order(pw[k]) for k in MATS}}
    names = {"wqkv": "self_attn.in_proj_weight", "wo": "self_attn.out_proj.weight", "fc1": "linear1.weight",
             "fc2": "linear2.weight"}
    for k, name in names.items():
        for i in range(TINY["num_layers"]):
            ref = sd[f"h.layers.{i}.{name}"].float()
            assert pw[k][i].shape == ref.shape, k
            if quant == "int8":
                s = pw[f"{k}_s"][i].reshape(-1, 1)
                assert pw[f"{k}_s"][i].shape == (1, ref.shape[0]), k
                assert float(((pw[k][i].float() * s - ref).abs() - 0.5 * s).max()) <= 1e-6, k
            else:
                torch.testing.assert_close(pw[k][i].float(), ref.to(torch.bfloat16).float(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_fragment_order_is_the_mma_a_fragments(dtype):
    """to_fragment_order puts, for each 16-row item, k-step s, lane 4 g + t
    and register j, the A-fragment values of mma.sync m16n8k32 s8 (int8) or
    m16n8k16 bf16 next to each other, as csrc/decode_step.cu item_mma reads
    them (16 bytes a lane at (s * 32 + lane) * 16); from_fragment_order
    inverts it."""
    rng = np.random.default_rng(5)
    l, n, k = 2, 32, 128
    w = torch.from_numpy(rng.integers(-127, 128, (l, n, k)).astype(np.float32)).to(dtype)
    f = pds.to_fragment_order(w)
    assert f.shape == w.shape and f.is_contiguous()
    torch.testing.assert_close(pds.from_fragment_order(f), w, rtol=0, atol=0)
    ks = 32 if dtype == torch.int8 else 16
    per = ks // 8  # values a register
    for layer in range(l):
        for item in range(n // 16):
            block = f[layer, item * 16:(item + 1) * 16].reshape(-1)  # the item, as one contiguous block
            for s_ in range(k // ks):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for j in range(4):
                        row = item * 16 + g + 8 * (j & 1)
                        k0 = s_ * ks + (ks // 2) * (j >> 1) + per * t
                        got = block[(s_ * 32 + lane) * 4 * per + j * per:][:per]
                        torch.testing.assert_close(got, w[layer, row, k0:k0 + per], rtol=0, atol=0)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("n_valid", [1, 33, 200])
def test_step_matches_pallas_at_other_prefixes(params, quant, n_valid):
    """The twin on the K-major stack against Pallas at live prefixes that
    end inside a 32-slot attention item of the step kernel (1, 33) and span
    several (200), at the bars of test_step_matches_pallas."""
    x, kv, mask = _case(1, seed=3)
    mask[:, :n_valid] = 1.0
    mask[:, n_valid:] = 0.0
    jw = jds.stack_weights_from_params(params, TINY["num_layers"], quant=quant)
    with pltpu.force_tpu_interpret_mode():
        yj, kvj = jds.fused_decode_step(
            jnp.asarray(x), jw, jnp.asarray(kv).astype(jnp.bfloat16), jnp.asarray(mask), jnp.asarray(n_valid),
            chunk=256, num_heads=TINY["num_heads"],
        )
    pw = _torch_weights(params, quant)
    yp, kvp = pds.fused_decode_step(torch.from_numpy(x), pw, torch.from_numpy(kv).to(torch.bfloat16),
                                    torch.from_numpy(mask), n_valid, num_heads=TINY["num_heads"])
    np.testing.assert_allclose(kvp[:, :, n_valid].float().numpy(), np.asarray(kvj, np.float32)[:, :, n_valid],
                               atol=2e-2, rtol=2e-2)
    head = np.asarray(params["params"]["predict"]["kernel"])
    lj, lp = np.asarray(yj) @ head, yp.numpy() @ head
    np.testing.assert_allclose(lp, lj, atol=5e-2, rtol=5e-2)
    assert np.corrcoef(lp.ravel(), lj.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("write_idx", [0, 1, 31, 32, 33, 745, 1023, 2047])
def test_step_splits_cover_the_prefix(write_idx):
    """The step kernel's attention splits (32 x slot_r slots each) cover the
    live prefix [0, write_idx) exactly once, with at least one split per
    (row, head), which also carries the fresh K/V when the prefix is empty;
    slot_r grows with the prefix only as far as the block's warps need, and
    stays within what each KV mode is built for."""
    for kv_int8 in (False, True):
        r, n = pds.step_splits(write_idx, kv_int8)
        assert r in ((1, 2, 4) if kv_int8 else (1, 2)) and 1 <= n <= pds.STEP_MAX_SPLITS
        slots = 32 * r
        covered = [t for s in range(n) for t in range(s * slots, min((s + 1) * slots, write_idx))]
        assert covered == list(range(write_idx))
        assert n == 1 or (n - 1) * slots < write_idx
        if r > 1:  # a smaller slot_r would have given a warp more than one split
            assert -(-write_idx // (16 * r)) > pds.STEP_WARPS


def test_step_splits_refuse_a_prefix_past_the_kernel():
    with pytest.raises(ValueError, match="at most"):
        pds.step_splits(pds.STEP_MAX_SPLITS * 64 + 1, False)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_step_request_refused_before_any_work(kv_int8):
    """check_step_request refuses, on every device, a request whose last
    step attends past the kernel's splits, and accepts the longest one they
    reach; on a card it also refuses widths other than STEP_DIMS, which the
    CPU twins take."""
    reach = pds.STEP_MAX_SPLITS * 32 * (4 if kv_int8 else 2)
    d, f, h = pds.STEP_DIMS
    for dev in ("cpu", "cuda"):
        pds.check_step_request(dev, d, f, h, reach, kv_int8)
        with pytest.raises(ValueError, match="at most"):
            pds.check_step_request(dev, d, f, h, reach + 1, kv_int8)
    pds.check_step_request("cpu", TINY["hidden_dim"], TINY["ffn_dim"], TINY["num_heads"], N_VALID, kv_int8)
    with pytest.raises(ValueError, match="built for"):
        pds.check_step_request("cuda", TINY["hidden_dim"], TINY["ffn_dim"], TINY["num_heads"], N_VALID, kv_int8)


# ---------------------------------------------------------------------------
# one write slot a row: write_idx of shape (B,), as continuous batching runs
# ---------------------------------------------------------------------------

ROW_SLOTS = {2: [N_VALID, 45], 3: [N_VALID, 45, 12]}  # rows at different steps; the sweep is max = N_VALID


def _rowwise_case(b, seed):
    """_case with row i live over [0, slots[i]) (row 0 keeps its hole)."""
    x, kv, mask = _case(b, seed)
    slots = np.asarray(ROW_SLOTS[b])
    mask[:] = np.arange(T_PAD)[None, :] < slots[:, None]
    mask[0, 5:9] = 0.0
    return x, kv, mask, slots


def _new_kv(kv, scales, slots, d):
    """(L, B, 2D): row i's K||V at slots[i], dequantized with its scales
    (L, B, 2, T) where given."""
    rows = np.arange(len(slots))
    new = kv[:, rows, slots]
    if scales is not None:
        s = scales[:, rows, :, slots]  # (B, L, 2): numpy puts the split advanced indices first
        new = np.concatenate([new[..., :d] * s[..., :1].transpose(1, 0, 2), new[..., d:] * s[..., 1:].transpose(1, 0, 2)], -1)
    return new


@pytest.mark.parametrize("kv_mode", ["bf16", "int8"])
@pytest.mark.parametrize("b", [2, 3])
def test_rowwise_step_matches_pallas(params, b, kv_mode):
    """The step with one write slot a row, rows at different slots, against
    Pallas in interpret mode with the same (B,) write_idx (the chunk
    covering the sweep, as in test_step_matches_pallas), at that test's
    bars: row i's new K/V at slots[i] (dequantized in int8-KV mode), the
    logits. Every other cache slot (and scale) is the input's, bit for
    bit, on both sides."""
    x, kv, mask, slots = _rowwise_case(b, seed=6)
    d = TINY["hidden_dim"]
    jw = jds.stack_weights_from_params(params, TINY["num_layers"])
    jkv = jnp.asarray(kv).astype(jnp.bfloat16)
    pkv = torch.from_numpy(kv).to(torch.bfloat16)
    jsc = psc = None
    if kv_mode == "int8":
        jkv, jsc = jds.quantize_kv_cache(jnp.asarray(kv))
        pkv, psc = pds.quantize_kv_cache(torch.from_numpy(kv))
    before = np.asarray(jkv, np.float32)
    with pltpu.force_tpu_interpret_mode():
        jout = jds.fused_decode_step(jnp.asarray(x), jw, jkv, jnp.asarray(mask), jnp.asarray(slots, jnp.int32), jsc,
                                     chunk=128, num_heads=TINY["num_heads"])
    pout = pds.fused_decode_step(torch.from_numpy(x), _torch_weights(params, "bf16"), pkv, torch.from_numpy(mask),
                                 torch.from_numpy(slots), psc, num_heads=TINY["num_heads"])
    kvj, kvp = np.asarray(jout[1], np.float32), pout[1].float().numpy()
    written = np.zeros((b, T_PAD), bool)
    written[np.arange(b), slots] = True
    for got in (kvj, kvp):
        np.testing.assert_array_equal(got[:, ~written], before[:, ~written])
    sj = sp = None
    if kv_mode == "int8":
        sj, sp = np.asarray(jout[2]), pout[2].numpy()
        for got in (sj, sp):  # the scales, (L, B, 2, T), as (L, B, T, 2)
            np.testing.assert_array_equal(got.transpose(0, 1, 3, 2)[:, ~written],
                                          np.asarray(jsc).transpose(0, 1, 3, 2)[:, ~written])
    np.testing.assert_allclose(_new_kv(kvp, sp, slots, d), _new_kv(kvj, sj, slots, d), atol=2e-2, rtol=2e-2)
    head = np.asarray(params["params"]["predict"]["kernel"])
    lj, lp = np.asarray(jout[0]) @ head, pout[0].numpy() @ head
    np.testing.assert_allclose(lp, lj, atol=5e-2, rtol=5e-2)
    assert np.corrcoef(lp.ravel(), lj.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("kv_mode", ["bf16", "int8"])
def test_rowwise_equal_slots_equal_the_scalar_step(params, kv_mode):
    """A write_idx whose entries are all equal is the scalar call, bit for
    bit: hidden state, cache and scales."""
    x, kv, mask = _case(3, seed=8)
    pw = _torch_weights(params, "int8")
    cache, sc = ((torch.from_numpy(kv).to(torch.bfloat16), None) if kv_mode == "bf16"
                 else pds.quantize_kv_cache(torch.from_numpy(kv)))

    def step(widx):
        return pds.fused_decode_step(torch.from_numpy(x), pw, cache.clone(), torch.from_numpy(mask), widx,
                                     None if sc is None else sc.clone(), num_heads=TINY["num_heads"])

    for g, r in zip(step(torch.full((3,), N_VALID)), step(N_VALID)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("widx", [
    torch.tensor([N_VALID, 3, 4]),  # (B + 1,)
    torch.tensor([[N_VALID, 3]]),  # 2-D
    torch.tensor([N_VALID, T_PAD]),  # a slot past the cache
    torch.tensor([-1, N_VALID]),  # a negative slot
    torch.tensor([N_VALID, 3.0]),  # not integers
    [N_VALID],  # a sequence of the wrong length
], ids=["rows+1", "2d", "past", "negative", "float", "short-list"])
@pytest.mark.parametrize("plain", [False, True])
def test_rowwise_refusals_before_any_work(params, widx, plain):
    """A write_idx of another shape than () or (B,), of a non-integer type,
    or with a slot outside [0, T) is refused by both functions before any
    work: the cache is left as it was."""
    x, kv, mask = _case(2, seed=9)
    cache = torch.from_numpy(kv).to(torch.bfloat16)
    before = cache.clone()
    fn = pds.fused_decode_step_plain if plain else pds.fused_decode_step
    with pytest.raises((ValueError, TypeError), match="write_idx"):
        fn(torch.from_numpy(x), _torch_weights(params, "bf16"), cache, torch.from_numpy(mask), widx,
           num_heads=TINY["num_heads"])
    torch.testing.assert_close(cache, before, rtol=0, atol=0)
