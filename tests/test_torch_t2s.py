"""Port of the S1 model (gpt_sovits_tpu_torch/models/t2s.py) against the
JAX package on the CPU, with the same weights and numpy-made inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.models import t2s as jt2s
from gpt_sovits_tpu.utils.config import S1Config as JS1Config
from gpt_sovits_tpu_torch.models import t2s as pt2s
from gpt_sovits_tpu_torch.utils.config import S1Config
from gpt_sovits_tpu_torch.weights import s1_from_jax

torch.set_num_threads(1)

CFG = dict(
    vocab_size=41, phoneme_vocab_size=37, embedding_dim=256, hidden_dim=256,
    num_heads=8, ffn_dim=512, num_layers=3, eos_id=40, bert_dim=16, max_len=128,
)


@pytest.fixture(scope="module")
def models():
    jm = jt2s.T2SDecoder(JS1Config(**CFG))
    params = jm.init(jax.random.PRNGKey(0), method=jt2s.T2SDecoder.init_all)
    pm = pt2s.T2SDecoder(S1Config(**CFG))
    pm.load_state_dict(s1_from_jax(jax.tree.map(np.asarray, params), pm.cfg), strict=True)
    return jm, params, pm.eval()


def _inputs(seed, b=2, tx=10, tp=7):
    rng = np.random.default_rng(seed)
    phones = rng.integers(0, CFG["phoneme_vocab_size"], (b, tx)).astype(np.int32)
    bert = (rng.standard_normal((b, tx, CFG["bert_dim"])) * 0.1).astype(np.float32)
    prompts = rng.integers(0, CFG["vocab_size"] - 1, (b, tp)).astype(np.int32)
    return phones, bert, prompts


def test_prefill_logits_allclose(models):
    """f32 on both sides: the only difference is summation order (1e-4)."""
    jm, params, pm = models
    phones, bert, prompts = _inputs(0)
    b, tx = phones.shape
    tp = prompts.shape[1]
    x_valid = np.ones((b, tx), bool)
    x_valid[1, :3] = False
    p_valid = np.ones((b, tp), bool)
    p_valid[1, -2:] = False
    x_pos = np.tile(np.arange(tx), (b, 1))
    p_pos = np.tile(np.arange(tp), (b, 1))
    jx = jm.apply(params, phones, bert, x_pos, method=jt2s.T2SDecoder.embed_text)
    jp = jm.apply(params, prompts, p_pos, method=jt2s.T2SDecoder.embed_audio)
    xy = jnp.concatenate([jx, jp], axis=1)
    bias_j = jt2s.build_prefix_attn_bias(jnp.asarray(x_valid), jnp.asarray(p_valid))
    lj, kj, vj = jm.apply(params, xy, bias_j, method=jt2s.T2SDecoder.prefill)
    with torch.no_grad():
        px = pm.embed_text(torch.from_numpy(phones).long(), torch.from_numpy(bert), torch.from_numpy(x_pos))
        pp = pm.embed_audio(torch.from_numpy(prompts).long(), torch.from_numpy(p_pos))
        bias_p = pt2s.build_prefix_attn_bias(torch.from_numpy(x_valid), torch.from_numpy(p_valid))
        np.testing.assert_array_equal(bias_p.numpy(), np.asarray(bias_j))
        lp, kp, vp = pm.prefill(torch.cat([px, pp], 1), bias_p)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-4)


def _gen_both(models, *, fused, seed=3, max_new=12, **kw):
    jm, params, pm = models
    phones, bert, prompts = _inputs(seed)
    b, tx = phones.shape
    tp = prompts.shape[1]
    lens = np.asarray([tx, tx - 3], np.int32)
    plens = np.asarray([tp, tp - 2], np.int32)
    # left-pad the phones of the short row as the pipeline does
    phones[1, :3] = 0
    opts = dict(max_new_tokens=max_new, top_k=1, repetition_penalty=1.0, early_stop_num=-1)
    opts.update(kw)
    args = (jm, params, jnp.asarray(phones), jnp.asarray(lens), jnp.asarray(bert), jnp.asarray(prompts), jnp.asarray(plens))
    if fused:
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            out_j = jt2s.generate(*args, jax.random.PRNGKey(1), use_fused_kernel=True, **opts)
    else:
        out_j = jt2s.generate(*args, jax.random.PRNGKey(1), **opts)
    out_p = pt2s.generate(
        pm, torch.from_numpy(phones).long(), torch.from_numpy(lens).long(), torch.from_numpy(bert),
        torch.from_numpy(prompts).long(), torch.from_numpy(plens).long(), torch.Generator().manual_seed(0),
        use_fused_kernel=fused, **opts,
    )
    return out_j, out_p


def test_generate_greedy_tokens_equal_xla_path(models):
    """Greedy (top_k=1) tokens are exactly the JAX XLA path's, at B=2 with
    ragged phoneme and prompt lengths, and with the repetition penalty on."""
    for kw in ({}, {"repetition_penalty": 1.35}):
        out_j, out_p = _gen_both(models, fused=False, max_new=16, **kw)
        np.testing.assert_array_equal(out_p.tokens.numpy(), np.asarray(out_j.tokens))
        np.testing.assert_array_equal(out_p.lengths.numpy(), np.asarray(out_j.lengths))


def test_generate_greedy_fused_path_agrees(models):
    """Fused step (port: plain twin on the CPU; JAX: Pallas in interpret
    mode). Both round the cache to bf16, so the bar is the JAX package's own
    between its two paths (test_decode_step_kernel.py:110): >= 0.9."""
    out_j, out_p = _gen_both(models, fused=True)
    tj, tp_ = np.asarray(out_j.tokens), out_p.tokens.numpy()
    n = min(int(np.asarray(out_j.lengths).min()), int(out_p.lengths.min()))
    assert n > 0
    assert (tj[:, :n] == tp_[:, :n]).mean() >= 0.9, (tj[:, :n], tp_[:, :n])


@pytest.mark.parametrize(
    "top_k,top_p,temperature,penalty",
    [(1, 1.0, 1.0, 1.0), (5, 1.0, 1.0, 1.35), (0, 0.8, 1.0, 1.0), (15, 0.7, 0.6, 1.35), (3, 0.9, 1.7, 1.2)],
)
def test_sample_token_filter_matches(top_k, top_p, temperature, penalty):
    """Penalty -> top-p -> temperature -> top-k on identical logits: every
    JAX sample lies in the port's support, and the JAX sample frequencies
    agree with the port's probabilities (3000 draws per row: the bound
    0.06 is about four binomial standard deviations at p = 0.5)."""
    rng = np.random.default_rng(7)
    b, v = 3, 30
    logits = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    presence = rng.random((b, v)) < 0.3
    kw = dict(top_k=top_k, top_p=top_p, temperature=temperature, repetition_penalty=penalty)
    filt = pt2s.filter_logits(torch.from_numpy(logits), torch.from_numpy(presence), **kw)
    probs = torch.softmax(filt, -1).numpy()
    n = 3000
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    draws = np.asarray(jax.vmap(
        lambda k: jt2s.sample_token(k, jnp.asarray(logits), jnp.asarray(presence), **kw)
    )(keys))  # (n, b)
    for r in range(b):
        assert np.all(probs[r, draws[:, r]] > 0), "JAX sampled outside the port's support"
        freq = np.bincount(draws[:, r], minlength=v) / n
        assert np.abs(freq - probs[r]).max() < 0.06
    if top_k == 1:
        ref = np.asarray(jt2s.sample_token(jax.random.PRNGKey(1), jnp.asarray(logits), jnp.asarray(presence), **kw))
        got = pt2s.sample_token(torch.from_numpy(logits), torch.from_numpy(presence), None, **kw).numpy()
        np.testing.assert_array_equal(got, ref)


def test_sine_position_table_equal():
    np.testing.assert_array_equal(pt2s.sine_position_table(64, 32), jt2s.sine_position_table(64, 32))


@pytest.mark.parametrize("kv_cache_quant", ["bf16", "int8"])
def test_fused_generate_refuses_a_prefix_past_the_step_kernel(models, monkeypatch, kv_cache_quant):
    """A request whose last step would attend past the step kernel's splits
    is refused with ValueError before the prefill or any step runs."""
    from gpt_sovits_tpu_torch.ops import decode_step as pds

    _, _, pm = models
    phones, bert, prompts = _inputs(5)
    b, tx = phones.shape
    tp = prompts.shape[1]
    reach = pds.STEP_MAX_SPLITS * 32 * (4 if kv_cache_quant == "int8" else 2)

    def no_work(*a, **k):
        raise AssertionError("work began before the request was refused")

    monkeypatch.setattr(pm, "prefill", no_work)
    monkeypatch.setattr(pds, "fused_decode_step", no_work)
    with pytest.raises(ValueError, match="at most"):
        pt2s.generate(
            pm, torch.from_numpy(phones).long(), torch.full((b,), tx), torch.from_numpy(bert),
            torch.from_numpy(prompts).long(), torch.full((b,), tp), torch.Generator().manual_seed(0),
            max_new_tokens=reach - tx - tp + 3, use_fused_kernel=True, kv_cache_quant=kv_cache_quant,
        )


@pytest.mark.parametrize("write_idx", [[5, 11, 8], [9, 9, 2]])
def test_decode_step_writes_each_row_at_its_slot(models, write_idx):
    """T2SDecoder.decode_step with a (B,) write_idx (rows at independent
    steps, as continuous batching runs them) against the JAX decode_step:
    row i's new K/V lands at write_idx[i] only, every other slot keeps its
    value, and the logits agree (f32 on both sides: 1e-4)."""
    jm, params, pm = models
    rng = np.random.default_rng(7)
    n_layers, h = CFG["num_layers"], CFG["num_heads"]
    b, t, dh = len(write_idx), 16, CFG["hidden_dim"] // CFG["num_heads"]
    k = (rng.standard_normal((n_layers, b, t, h, dh)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((n_layers, b, t, h, dh)) * 0.5).astype(np.float32)
    emb = (rng.standard_normal((b, 1, CFG["embedding_dim"])) * 0.5).astype(np.float32)
    valid = np.arange(t)[None, :] <= np.asarray(write_idx)[:, None]  # each row's prefix and its own slot
    widx = np.asarray(write_idx, np.int32)
    lj, kj, vj = jm.apply(params, jnp.asarray(emb), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
                          jnp.asarray(widx), method=jt2s.T2SDecoder.decode_step)
    kp, vp = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    with torch.no_grad():
        lp = pm.decode_step(torch.from_numpy(emb), kp, vp, torch.from_numpy(valid), torch.from_numpy(widx).long())
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    for got, want, before in ((kp.numpy(), np.asarray(kj), k), (vp.numpy(), np.asarray(vj), v)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        written = np.zeros((b, t), bool)
        written[np.arange(b), widx] = True
        np.testing.assert_array_equal(got[:, ~written], before[:, ~written])
        assert np.abs(got[:, written] - before[:, written]).min() > 0
