"""The port's continuous batcher (gpt_sovits_tpu_torch/infer/continuous.py)
against the JAX package's (gpt_sovits_tpu/infer/continuous.py) and against
the port's `generate`, at test_continuous.py's tiny S1 configuration with
weights drawn from a seed with numpy (test_torch_pipeline.random_params)
and carried over by weights.s1_from_jax. Greedy tokens are compared for
equality; the int8-KV pool at the JAX test's agreement bar (0.8)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from gpt_sovits_tpu.infer.continuous import SAMPLE_CAP
from gpt_sovits_tpu.infer.continuous import ContinuousBatcher as JBatcher
from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.utils.config import S1Config as JS1Config
from gpt_sovits_tpu_torch.infer import continuous as cont
from gpt_sovits_tpu_torch.infer.continuous import ContinuousBatcher, filter_logits_rows, sample_token_rows
from gpt_sovits_tpu_torch.models.t2s import EOS_MASK_WARMUP_STEPS, T2SDecoder, filter_logits, generate
from gpt_sovits_tpu_torch.ops import decode_step as ds
from gpt_sovits_tpu_torch.utils.config import S1Config
from gpt_sovits_tpu_torch.utils.metrics import recorder
from gpt_sovits_tpu_torch.weights import s1_from_jax
from test_torch_pipeline import random_params

torch.set_num_threads(1)

CFG = dict(vocab_size=41, phoneme_vocab_size=100, embedding_dim=48, hidden_dim=48, num_heads=4, ffn_dim=96,
           num_layers=2, eos_id=40, bert_dim=8, max_len=1024, semantic_frame_rate=25)
ARGMAX = dict(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=1.35)
POOL = dict(tx_max=16, tp_max=16)


@pytest.fixture(scope="module")
def models():
    jm = JT2S(JS1Config(**CFG))
    params = random_params(jm, method=JT2S.init_all, seed=11)
    m = T2SDecoder(S1Config(**CFG))
    m.load_state_dict(s1_from_jax(jax.tree.map(np.asarray, params), m.cfg), strict=True)
    return jm, params, m.eval()


def _mk_request(seed, tx=12, tp=9):
    rng = np.random.default_rng(seed)
    phones = rng.integers(1, CFG["phoneme_vocab_size"], tx).astype(np.int32)
    bert = rng.standard_normal((tx, CFG["bert_dim"])).astype(np.float32) * 0.1
    prompt = rng.integers(0, CFG["vocab_size"] - 1, tp).astype(np.int32)
    return phones, bert, prompt


def _generate_tokens(m, phones, bert, prompt, max_new):
    """The port's single-request generate() under argmax (plain step)."""
    out = generate(
        m, torch.from_numpy(phones[None].astype(np.int64)), torch.tensor([len(phones)]), torch.from_numpy(bert[None]),
        torch.from_numpy(prompt[None].astype(np.int64)), torch.tensor([len(prompt)]), torch.Generator().manual_seed(0),
        max_new_tokens=max_new, early_stop_num=max_new, **ARGMAX,
    )
    return out.tokens[0, : int(out.lengths[0])].numpy()


def _pool(m, slots, max_new, **kw):
    return ContinuousBatcher(m, slots=slots, max_new=max_new, device="cpu", **{**POOL, **ARGMAX, **kw})


def _jpool(jm, params, slots, max_new, **kw):
    return JBatcher(jm, params, slots=slots, max_new=max_new, **{**POOL, **ARGMAX, **kw})


def _staggered(cb, reqs, n=5):
    """Submit reqs[0], run a segment, submit reqs[1] (it joins mid-decode),
    run a segment, submit the rest (queued or joining) and drain."""
    rids = [cb.submit(*reqs[0])]
    got = dict(cb.step(n))
    rids.append(cb.submit(*reqs[1]))
    got.update(cb.step(n))
    rids += [cb.submit(*r) for r in reqs[2:]]
    got.update(cb.drain(n))
    return rids, got


def test_single_request_matches_generate_and_jax(models):
    jm, params, m = models
    req = _mk_request(1)
    max_new = 24
    want = _generate_tokens(m, *req, max_new)
    cb = _pool(m, 2, max_new)
    rid = cb.submit(*req)
    got = cb.drain(n=7)
    jcb = _jpool(jm, params, 2, max_new)
    jrid = jcb.submit(*req)
    np.testing.assert_array_equal(got[rid], want)
    np.testing.assert_array_equal(got[rid], jcb.drain(n=7)[jrid])
    assert cb.pending == 0 and cb.steps_run == 7 * cb._segments_run


def _since(spans: dict, t_from: int) -> dict:
    keep = spans["t0"] >= t_from
    return {c: v[keep] for c, v in spans.items()}


def test_staggered_admission_matches_generate_and_jax(models):
    jm, params, m = models
    max_new = 24
    reqs = [_mk_request(s) for s in (2, 3, 4)]
    cb = _pool(m, 2, max_new)
    t_from = time.perf_counter_ns()
    rids, got = _staggered(cb, reqs)
    jrids, jgot = _staggered(_jpool(jm, params, 2, max_new), reqs)
    for rid, jrid, req in zip(rids, jrids, reqs):
        np.testing.assert_array_equal(got[rid], _generate_tokens(m, *req, max_new))
        np.testing.assert_array_equal(got[rid], jgot[jrid])
    # request 1 was admitted before request 0 finished: a join mid-decode
    snap = recorder().snapshot()
    admitted = _since(snap.spans_named("pool.queue"), t_from)
    evicted = _since(snap.spans_named("pool.evict"), t_from)
    admitted_at = dict(zip(admitted["rid"].tolist(), admitted["t1"].tolist()))
    finished_at = dict(zip(evicted["rid"].tolist(), evicted["t0"].tolist()))
    assert admitted_at[rids[1]] < finished_at[rids[0]]
    assert cb.peak_live == 2


def test_pool_records_queue_waits_admissions_passes_and_row_steps(models):
    """Every row's queue wait ends at its admission; each pass records its
    steps and the rows it advanced, as its segment does; the decoded
    row-steps the flag copies count equal the tokens returned less each
    row's first (the admission's draw), and never exceed the segments'
    steps times their rows."""
    _, _, m = models
    max_new, n = 16, 5
    reqs = [_mk_request(30 + s, tx=8 + s) for s in range(5)]
    cb = _pool(m, 2, max_new, top_k=5, temperature=1.0)
    t_from = time.perf_counter_ns()
    rids = [cb.submit(*r) for r in reqs]
    got = cb.drain(n=n)
    snap = recorder().snapshot()
    queue = _since(snap.spans_named("pool.queue"), t_from)
    admits = _since(snap.spans_named("pool.admit"), t_from)
    passes = _since(snap.spans_named("pool.pass"), t_from)
    segments = _since(snap.spans_named("pool.segment"), t_from)
    assert sorted(queue["rid"].tolist()) == sorted(rids) and (queue["t1"] >= queue["t0"]).all()
    assert set(queue["parent"].tolist()) <= set(admits["seq"].tolist())
    assert sum(admits["attr"][:, 0].tolist()) == len(rids)
    for child in ("pool.prefill", "pool.draw", "pool.install"):
        assert set(_since(snap.spans_named(child), t_from)["parent"].tolist()) == set(admits["seq"].tolist())
    assert len(passes["seq"]) == cb._segments_run + (passes["attr"][:, 0] == 0).sum()
    assert passes["attr"][:, 0].sum() == cb.steps_run == segments["attr"][:, 0].sum()
    assert set(segments["parent"].tolist()) <= set(passes["seq"].tolist())
    assert (passes["attr"][:, 1] >= 0).all() and (passes["attr"][:, 2] == 0).all()  # no copy waits on the CPU
    seg_rows = dict(zip(segments["parent"].tolist(), segments["attr"][:, 1].tolist()))
    assert [seg_rows.get(int(q), 0) for q in passes["seq"]] == passes["attr"][:, 3].tolist()
    assert 0 < passes["attr"][:, 3].max() <= 2
    decoded = sum(_since_counts(snap, "pool.decoded_row_steps", t_from))
    installed = int((segments["attr"][:, 0] * segments["attr"][:, 1]).sum())
    assert decoded == sum(len(got[r]) - 1 for r in rids) and 0 < decoded <= installed


def _since_counts(snap, name: str, t_from: int) -> list:
    c = snap.counts_named(name)
    return c["value"][c["t"] >= t_from].tolist()


def test_more_requests_than_slots(models):
    jm, params, m = models
    max_new = 16
    reqs = [_mk_request(10 + s) for s in range(5)]
    cb = _pool(m, 2, max_new)
    rids = [cb.submit(*r) for r in reqs]
    got = cb.drain(n=8)
    jcb = _jpool(jm, params, 2, max_new)
    jrids = [jcb.submit(*r) for r in reqs]
    jgot = jcb.drain(n=8)
    assert set(got) == set(rids)
    for rid, jrid in zip(rids, jrids):
        assert 1 <= len(got[rid]) <= max_new and np.all(got[rid] < CFG["vocab_size"])
        np.testing.assert_array_equal(got[rid], jgot[jrid])


def test_cap_terminates(models):
    _, _, m = models
    cb = _pool(m, 1, 8)
    rid = cb.submit(*_mk_request(42))
    done = cb.drain(n=4)
    assert rid in done and len(done[rid]) <= 8
    assert cb.pending == 0


def test_length_validation(models):
    _, _, m = models
    cb = ContinuousBatcher(m, slots=1, tx_max=8, tp_max=8, max_new=8, device="cpu", **ARGMAX)
    with pytest.raises(ValueError, match="phones length"):
        cb.submit(np.ones(20, np.int32), None, np.ones(4, np.int32))
    with pytest.raises(ValueError, match="prompt length"):
        cb.submit(np.ones(4, np.int32), None, np.ones(20, np.int32))


def test_fused_pool_matches_jax_fused_pool(models):
    """The fused pool on K1's twin equals the JAX fused pool (Pallas in
    interpret mode), token for token, and both equal the plain pool."""
    jm, params, m = models
    max_new = 12
    reqs = [_mk_request(s) for s in (21, 22)]
    cb = _pool(m, 2, max_new, use_fused=True)
    rids = [cb.submit(*r) for r in reqs]
    got = cb.drain(n=6)
    plain = _pool(m, 2, max_new, use_fused=False)
    prids = [plain.submit(*r) for r in reqs]
    want = plain.drain(n=6)
    with pltpu.force_tpu_interpret_mode():
        jcb = _jpool(jm, params, 2, max_new, use_fused=True)
        jrids = [jcb.submit(*r) for r in reqs]
        jgot = jcb.drain(n=6)
    assert cb.use_fused and not cb.kv_quant and cb.state.kv.shape == plain.state.kv.shape == (2, 2, 512, 96)
    for rid, jrid, prid in zip(rids, jrids, prids):
        np.testing.assert_array_equal(got[rid], jgot[jrid])
        np.testing.assert_array_equal(got[rid], want[prid])


def test_fused_kv_int8_close(models):
    """The fused pool with an int8 KV pool stays on the plain pool's greedy
    trajectory: agreement >= 0.8, the JAX test's bar."""
    _, _, m = models
    max_new = 12
    reqs = [_mk_request(s) for s in (31, 32)]
    ref = _pool(m, 2, max_new, use_fused=False)
    rids_ref = [ref.submit(*r) for r in reqs]
    want = ref.drain(n=6)
    cb = _pool(m, 2, max_new, use_fused=True, kv_quant="int8")
    rids = [cb.submit(*r) for r in reqs]
    got = cb.drain(n=6)
    assert cb.state.kv.dtype == torch.int8 and cb.state.kv_scales.shape == (2, 2, 2, 512)
    total = agree = 0
    for rr, rq in zip(rids_ref, rids):
        a, g = want[rr], got[rq]
        n = min(len(a), len(g))
        total += n
        agree += (a[:n] == g[:n]).sum()
    assert agree / max(total, 1) >= 0.8, (agree, total)


def test_fused_step_gets_host_slots(models, monkeypatch):
    """Each pool step hands K1 its rows' write slots as a host list (no
    device read a token): scratch + (tokens sampled) - 1 for an installed
    row, scratch for an empty one, and the pool's fixed split plan."""
    _, _, m = models
    calls = []
    real = ds.fused_decode_step

    def spy(*args, **kw):
        calls.append((args[4], kw["plan_sweep"]))
        return real(*args, **kw)

    monkeypatch.setattr(ds, "fused_decode_step", spy)
    cb = _pool(m, 2, 12, use_fused=True)
    cb.submit(*_mk_request(21))
    cb.step(3)
    cb.submit(*_mk_request(22))
    cb.step(2)
    scratch = POOL["tx_max"] + POOL["tp_max"]
    want = [[scratch + i, scratch] for i in range(3)] + [[scratch + 3 + i, scratch + i] for i in range(2)]
    assert [c[0] for c in calls] == want
    assert all(type(v) is int for c in calls for v in c[0])
    assert {c[1] for c in calls} == {scratch + 12}


def test_split_plan_fixed_per_pool():
    """With a plan sweep, every step of a pool takes the same slot_r, so the
    kernel cuts each row's prefix at the same places whatever its
    co-tenants' slots; without one the plan is step_splits'."""
    for kv_int8 in (False, True):
        for n in (1, 40, 300, 1400, 3000):
            r, splits = ds.step_plan(n, kv_int8)
            assert (r, splits) == ds.step_splits(n, kv_int8)
        plans = {ds.step_plan(n, kv_int8, plan_sweep=1324)[0] for n in range(1, 1325)}
        assert plans == {ds.step_splits(1324, kv_int8)[0]}
        for n in (1, 200, 1024, 1324):
            r, splits = ds.step_plan(n, kv_int8, plan_sweep=1324)
            assert splits * 32 * r >= n and (splits - 1) * 32 * r < max(n, 1)


def test_pool_refusals(models, monkeypatch):
    """On a card, a pool wider than K1's rows raises instead of falling back
    to the plain step; a sweep past K1's reach is refused at construction
    on every device; an unknown KV mode is refused."""
    _, _, m = models
    monkeypatch.setattr(cont, "resolve_device", lambda device: torch.device("cuda"))
    for use_fused in (None, True):
        with pytest.raises(ValueError, match="1..8 rows"):
            ContinuousBatcher(m, slots=ds.MAX_ROWS + 1, use_fused=use_fused, **POOL, max_new=8)
    monkeypatch.undo()
    ContinuousBatcher(m, slots=ds.MAX_ROWS + 1, device="cpu", **POOL, max_new=8)  # the twin takes any
    with pytest.raises(ValueError, match="at most"):
        ContinuousBatcher(m, slots=1, device="cpu", use_fused=True, kv_quant="int8", tx_max=16, tp_max=16,
                          max_new=17000)
    with pytest.raises(ValueError, match="kv quant"):
        ContinuousBatcher(m, slots=1, device="cpu", kv_quant="fp8", **POOL, max_new=8)


def test_lookahead_from_environment(models, monkeypatch):
    _, _, m = models
    monkeypatch.setenv("GSVT_CB_LOOKAHEAD", "5")
    assert _pool(m, 1, 8).lookahead == 5
    assert _pool(m, 1, 8, lookahead=0).lookahead == 0
    monkeypatch.delenv("GSVT_CB_LOOKAHEAD")
    assert _pool(m, 1, 8).lookahead == 2


@pytest.mark.parametrize("lookahead", [0, 1, 3])
def test_lookahead_depth_keeps_tokens(models, lookahead):
    """Flags applied 0-3 segments late only delay eviction: the tokens are
    the same at every depth."""
    _, _, m = models
    reqs = [_mk_request(s) for s in (70, 71, 72)]
    want = {i: _generate_tokens(m, *r, 16) for i, r in enumerate(reqs)}
    cb = _pool(m, 2, 16, lookahead=lookahead)
    rids, got = _staggered(cb, reqs, n=3)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(got[rid], want[i])


def test_per_request_seed_reproducible(models):
    """A seeded request's tokens are the same alone and among co-tenants
    (its own stream of draws, per-row sampling)."""
    _, _, m = models
    max_new = 16
    req = _mk_request(50)
    sampling = dict(top_k=5, top_p=0.9, temperature=0.9, repetition_penalty=1.2)
    cb1 = ContinuousBatcher(m, slots=2, max_new=max_new, device="cpu", **POOL)
    r_alone = cb1.submit(*req, seed=7, **sampling)
    alone = cb1.drain(n=5)[r_alone]
    cb2 = ContinuousBatcher(m, slots=2, max_new=max_new, device="cpu", **POOL)
    cb2.submit(*_mk_request(51), seed=8, temperature=1.3)  # a co-tenant with other options
    cb2.step(n=3)  # mid-decode when ours joins
    r_shared = cb2.submit(*req, seed=7, **sampling)
    shared = cb2.drain(n=5)[r_shared]
    np.testing.assert_array_equal(alone, shared)
    cb3 = ContinuousBatcher(m, slots=2, max_new=max_new, device="cpu", **POOL)
    r_other = cb3.submit(*req, seed=9, **sampling)
    assert not np.array_equal(cb3.drain(n=5)[r_other], alone)  # the seed does choose the draws


def test_mixed_sampling_params_one_pool(models):
    """A greedy row decodes its generate() trajectory while it shares the
    pool with a hot row."""
    _, _, m = models
    max_new = 16
    req = _mk_request(60)
    want = _generate_tokens(m, *req, max_new)
    cb = ContinuousBatcher(m, slots=2, max_new=max_new, device="cpu", top_k=50, top_p=1.0, temperature=1.5,
                           repetition_penalty=1.0, **POOL)
    hot = cb.submit(*_mk_request(61))  # the pool's default (hot) sampling
    rid = cb.submit(*req, top_k=1, repetition_penalty=1.35)
    got = cb.drain(n=5)
    np.testing.assert_array_equal(got[rid], want)
    assert len(got[hot]) > 0


def test_one_cache_layout_in_both_modes(models):
    """The plain pool keeps the fused pool's K||V cache (f32 against bf16),
    written through views of its halves: after the same greedy steps of the
    same request both caches hold the same K and V at the same slots, within
    bf16 rounding of the twin's activations (relative L2 error < 0.02)."""
    _, _, m = models
    caches = {}
    for use_fused in (False, True):
        cb = _pool(m, 2, 12, use_fused=use_fused)
        cb.submit(*_mk_request(21))
        cb.step(5)
        caches[use_fused] = (cb.state.kv.float(), cb.state.mask.clone())
    (plain, mask_p), (fused, mask_f) = caches[False], caches[True]
    assert plain.shape == fused.shape == (2, 2, 512, 2 * CFG["hidden_dim"])
    assert torch.equal(mask_p, mask_f) and int(mask_p[0].sum()) == 12 + 9 + 5
    for half in (slice(0, CFG["hidden_dim"]), slice(CFG["hidden_dim"], None)):
        a, b = plain[:, 0, :, half], fused[:, 0, :, half]  # the live row (the empty one decodes masked)
        assert torch.equal(a != 0, b != 0)  # the same slots written
        assert float((a - b).norm() / b.norm()) < 0.02


def test_admission_prefills_only_the_admitted_rows(models, monkeypatch):
    """An admission prefills exactly the requests it takes: 3 rows into a
    pool of 4 free slots, then 1."""
    _, _, m = models
    sizes = []
    real = cont._prefill
    monkeypatch.setattr(cont, "_prefill", lambda model, phones, *a, **kw: sizes.append(phones.shape[0])
                        or real(model, phones, *a, **kw))
    cb = _pool(m, 4, 8)
    for s in (90, 91, 92):
        cb.submit(*_mk_request(s))
    cb.step(2)
    cb.submit(*_mk_request(93))
    cb.drain(n=4)
    assert sizes == [3, 1]


def test_warmup_leaves_an_empty_pool(models):
    """warmup admits a full pool, runs one segment and drops the dummy rows
    where they stand: nothing pending, no slot held, and the next request
    decodes its generate() trajectory."""
    _, _, m = models
    cb = _pool(m, 2, 16)
    cb.warmup(segment=3)
    assert cb.pending == 0 and cb.steps_run == 3 and not cb.state.active.any()
    assert cb._slot_rid == [None, None] and not cb._flag_q and not cb._slot_hold
    req = _mk_request(95)
    rid = cb.submit(*req)
    np.testing.assert_array_equal(cb.drain(n=5)[rid], _generate_tokens(m, *req, 16))


# -- the step's tail and its graph -------------------------------------------


def _reference_segment(cb, n):
    """A segment as the pool ran it before its step was split into K1 and a
    tail: fresh tensors of the segment's write slots and uniforms, a step
    indexing its row by the host loop, K1's output a new tensor."""
    installed = np.array([r is not None for r in cb._slot_rid])
    g = np.where(installed[None], np.minimum(cb._count[None] + np.arange(n)[:, None], cb.max_new), 0)
    slots = cb.scratch + np.maximum(g - 1, 0)
    uniform = np.zeros((n, cb.slots), np.float32)
    for i in np.flatnonzero(installed):
        uniform[:, i] = cb._draws[i].random(n, dtype=np.float32)
    s, cfg, rows = cb.state, cb.model.cfg, cb._rows
    eos = cfg.eos_id
    for i in range(n):
        write_dev, u = torch.from_numpy(slots[i]), torch.from_numpy(uniform[i])
        live = s.active & ~s.done
        if cb.use_fused:
            y = ds.fused_decode_step(s.tok_emb[:, 0].contiguous(), cb.fused_weights, s.kv, s.mask, slots[i].tolist(),
                                     s.kv_scales, num_heads=cfg.num_heads, plan_sweep=cb.plan_sweep)[0]
            s.mask[rows, write_dev] = torch.maximum(s.mask[rows, write_dev], live.float())
            logits = F.linear(y, cb.head)
        else:
            s.mask[rows, write_dev] = torch.maximum(s.mask[rows, write_dev], live.float())
            logits = cb.model.decode_step(s.tok_emb, *cb._kv_halves, s.mask > 0, write_dev)
        logits[:, eos] = torch.where(s.gen_count < EOS_MASK_WARMUP_STEPS, float("-inf"), logits[:, eos])
        argmax_is_eos = logits.argmax(-1) == eos
        tok = sample_token_rows(logits, s.presence, s.top_k, s.top_p, s.temperature, s.rep_penalty, u)
        newly_done = live & (argmax_is_eos | (tok == eos) | (s.gen_count >= cb.max_new))
        keep = live & ~newly_done
        tok = torch.where(keep, tok, 0)
        write_pos = torch.clamp_max(s.gen_count, cb.max_new - 1)
        s.tokens[rows, write_pos] = torch.where(keep, tok, s.tokens[rows, write_pos])
        s.lengths += keep
        s.done |= newly_done
        s.presence[rows, tok] |= live
        pos = torch.clamp(s.prompt_lens + s.gen_count, 0, cfg.max_len - 1)
        s.tok_emb.copy_(torch.where(live[:, None, None], cb.model.embed_audio(tok[:, None], pos[:, None]), s.tok_emb))
        s.gen_count += keep
    cb._count = np.where(installed, np.minimum(cb._count + n, cb.max_new), 0)
    cb.steps_run += n


# greedy and sampled rows, each request with its own seed
TAIL_MIX = [dict(top_k=1), dict(top_k=5, temperature=1.0), dict(top_k=15, temperature=0.7, top_p=0.9),
            dict(top_k=5, temperature=0.7), dict(top_k=1, repetition_penalty=1.0)]


def _mixed_tokens(cb, n, max_new):
    """Five requests of mixed sampling through a 2-slot pool (joins,
    evictions and reinstalls), drained in segments of n."""
    rids = [cb.submit(*_mk_request(80 + i, tx=6 + i), seed=100 + i, **kw) for i, kw in enumerate(TAIL_MIX)]
    got = cb.drain(n=n)
    return [got[r] for r in rids]


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("n", [1, 7, 25])
def test_split_step_keeps_tokens(models, use_fused, n):
    """K1 (its twin here) and the tail over the staged write slots and
    uniforms give the tokens of the step before the split, greedy and
    sampled, bit for bit."""
    _, _, m = models
    max_new = 20
    cb = _pool(m, 2, max_new, use_fused=use_fused)
    ref = _pool(m, 2, max_new, use_fused=use_fused)
    ref._segment = lambda k: _reference_segment(ref, k)
    got, want = _mixed_tokens(cb, n, max_new), _mixed_tokens(ref, n, max_new)
    assert [len(t) for t in got] == [len(t) for t in want] and any(len(t) > 1 for t in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert cb.steps_run == ref.steps_run


def test_cpu_pool_captures_no_graph(models):
    """A pool on the CPU runs its tail eagerly: no capture, and each segment
    stamps `pool.graph_steps` with 0 inside its span."""
    _, _, m = models
    for use_fused in (False, True):
        cb = _pool(m, 2, 12, use_fused=use_fused)
        t_from = time.perf_counter_ns()
        _mixed_tokens(cb, 4, 12)
        snap = recorder().snapshot()
        counts = snap.counts_named("pool.graph_steps")
        t = counts["t"][counts["t"] >= t_from]
        segments = _since(snap.spans_named("pool.segment"), t_from)
        assert cb.graph_captures == 0 and not cb._graphable()
        assert _since_counts(snap, "pool.graph_steps", t_from) == [0] * cb._segments_run == [0] * len(segments["seq"])
        assert ((segments["t0"] <= t) & (t <= segments["t1"])).all()


class _EagerGraph:
    """A stand-in for the tail's CUDA graph on the CPU: the capture runs the
    tail once, as the real capture's warm-up does (the step's own work),
    and each replay runs it again."""

    def __init__(self, tail, device):
        self.tail = tail
        tail()

    def replay(self):
        self.tail()


def test_replayed_tail_keeps_tokens(models, monkeypatch):
    """With the graph's place taken by a stand-in that reruns the tail, the
    pool captures once at its first step, counts every later step as a
    replay, and gives the eager pool's tokens: the tail advances its own
    step index. Its staged buffers hold max_new steps: a longer segment
    keeps them, and the graph, and the tokens. A profiler running changes
    nothing: the steps still replay."""
    _, _, m = models
    max_new = 20
    want = _mixed_tokens(_pool(m, 2, max_new, use_fused=True), 7, max_new)
    monkeypatch.setattr(cont, "_TailGraph", _EagerGraph)
    monkeypatch.setattr(ContinuousBatcher, "_graphable", lambda self: True)
    cb = _pool(m, 2, max_new, use_fused=True)
    t_from = time.perf_counter_ns()
    got = _mixed_tokens(cb, 7, max_new)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert cb.graph_captures == 1
    assert sum(_since_counts(recorder().snapshot(), "pool.graph_steps", t_from)) == cb.steps_run - 1
    longer = _mixed_tokens(cb, 25, max_new)
    for a, b in zip(longer, _mixed_tokens(_pool(m, 2, max_new, use_fused=True), 25, max_new)):
        np.testing.assert_array_equal(a, b)
    assert cb.graph_captures == 1 and cb._slots_dev.shape == (max_new, 2)
    t_from = time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cb.submit(*_mk_request(91))
        cb.step(5)
    assert _since_counts(recorder().snapshot(), "pool.graph_steps", t_from) == [5] and cb.graph_captures == 1


def test_step_output_buffer(models):
    """fused_decode_step writes its hidden state into `out` where given and
    returns it: equal to a call without it; `out` may not be the input."""
    _, _, m = models
    cb = _pool(m, 2, 12, use_fused=True)
    cb.submit(*_mk_request(21))
    cb.step(3)
    s = cb.state
    args = (s.tok_emb[:, 0].contiguous(), cb.fused_weights)
    want, kv_want = ds.fused_decode_step(*args, s.kv.clone(), s.mask, [20, 16], num_heads=CFG["num_heads"])
    out = torch.full_like(want, float("nan"))
    got, kv_got = ds.fused_decode_step(*args, s.kv.clone(), s.mask, [20, 16], num_heads=CFG["num_heads"], out=out)
    assert got is out and torch.equal(got, want) and torch.equal(kv_got, kv_want)
    with pytest.raises(ValueError, match="must not be x"):
        ds.fused_decode_step(args[0], cb.fused_weights, s.kv, s.mask, [20, 16], num_heads=CFG["num_heads"], out=args[0])
    with pytest.raises(ValueError, match="out: shape"):
        ds.fused_decode_step(*args, s.kv, s.mask, [20, 16], num_heads=CFG["num_heads"], out=out[:1])


# -- sampling -------------------------------------------------------------

ROWS = [  # (top_k, top_p, temperature, repetition penalty)
    (15, 1.0, 1.0, 1.35), (1, 1.0, 1.0, 1.35), (0, 0.9, 0.7, 1.0), (50, 0.5, 1.3, 1.2), (1025, 0.99, 0.0, 1.0),
    (5, 1.0, 2.0, 1.0), (-1, 1.0, 1.0, 1.0), (100, 0.3, 1.0, 1.35),
]


def _logits(seed, v=1025):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((len(ROWS), v), generator=g) * 3.0
    presence = torch.rand((len(ROWS), v), generator=g) < 0.1
    return logits, presence


def _params(rows):
    return (torch.tensor([r[0] for r in rows]), torch.tensor([r[1] for r in rows], dtype=torch.float32),
            torch.tensor([r[2] for r in rows], dtype=torch.float32), torch.tensor([r[3] for r in rows], dtype=torch.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_rows_equal_filter_logits_bit_for_bit(seed):
    """Row i of filter_logits_rows is filter_logits of row i with row i's
    scalars, bit for bit (-inf where both leave the support)."""
    logits, presence = _logits(seed)
    got = filter_logits_rows(logits, presence, *_params(ROWS))
    for i, (k, p, t, rp) in enumerate(ROWS):
        want = filter_logits(logits[i : i + 1], presence[i : i + 1], top_k=k, top_p=p, temperature=t,
                             repetition_penalty=rp)
        assert torch.equal(got[i : i + 1], want), (i, ROWS[i])


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_rows_draw_inside_the_support(seed):
    """Greedy rows take filter_logits' argmax; every other row takes the
    token whose CDF interval holds its uniform, always inside the support,
    and a row's token depends only on its own logits and uniform."""
    logits, presence = _logits(seed)
    params = _params(ROWS)
    u = torch.tensor([0.0, 0.5, 0.999999, 0.25, 0.75, 0.1, 0.6, 0.9999999])
    tok = sample_token_rows(logits, presence, *params, u)
    filtered = filter_logits_rows(logits, presence, *params)
    probs = torch.softmax(filtered, -1)
    cdf = torch.cumsum(probs, -1)
    for i, (k, *_rest) in enumerate(ROWS):
        t = int(tok[i])
        assert probs[i, t] > 0, (i, t)
        if k == 1:
            assert t == int(filtered[i].argmax())
        else:
            x = float(u[i] * cdf[i, -1])
            assert (float(cdf[i, t - 1]) if t else 0.0) <= x < float(cdf[i, t]) or t == int(probs[i].nonzero()[-1])
        alone = sample_token_rows(logits[i : i + 1], presence[i : i + 1], *(q[i : i + 1] for q in params), u[i : i + 1])
        assert int(alone[0]) == t


@pytest.mark.parametrize("top_k", [1, 5, 15, 100])
def test_sampling_support_equals_jax_top128(top_k):
    """At top_k <= 128 and top_p = 1 the full-vocabulary filter keeps the
    same tokens as the JAX pool's top-SAMPLE_CAP computation
    (continuous.py:90-114), with the same probabilities within 1e-6."""
    assert top_k <= SAMPLE_CAP
    g = torch.Generator().manual_seed(top_k)
    b, v = 4, 1025
    logits = torch.randn((b, v), generator=g) * 3.0
    presence = torch.rand((b, v), generator=g) < 0.1
    temp = torch.tensor([1.0, 0.7, 1.3, 1.0])
    rp = torch.tensor([1.35, 1.0, 1.2, 1.35])
    k = torch.full((b,), top_k)
    probs = torch.softmax(filter_logits_rows(logits, presence, k, torch.ones(b), temp, rp), -1).numpy()

    lj, pj = jnp.asarray(logits.numpy()), jnp.asarray(presence.numpy())
    penalized = jnp.where(lj < 0, lj * rp.numpy()[:, None], lj / rp.numpy()[:, None])
    lj = jnp.where(pj, penalized, lj)
    vals, idxs = jax.lax.top_k(lj, SAMPLE_CAP)
    cum = jnp.cumsum(jax.nn.softmax(vals, axis=-1), axis=-1)
    remove = (cum > 1.0).at[:, 0].set(False) | (jnp.arange(SAMPLE_CAP)[None, :] >= top_k)
    p_cap = jax.nn.softmax(jnp.where(remove, -jnp.inf, vals) / jnp.maximum(temp.numpy(), 1e-5)[:, None], axis=-1)
    want = np.zeros((b, v), np.float32)
    np.put_along_axis(want, np.asarray(idxs), np.asarray(p_cap), axis=1)
    np.testing.assert_array_equal(probs > 0, want > 0)
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-6)
