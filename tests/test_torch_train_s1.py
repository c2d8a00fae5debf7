"""S1 training in the port (gpt_sovits_tpu_torch/models/t2s.py t2s_loss,
train/s1_train.py, train/scaled_adam.py, train/optim.py) held against the
JAX package's on the CPU: the loss, one AdamW update and one update of 4
accumulated micro-steps (gradients, parameter changes, Adam moments), the
schedule, DPO with JAX's draws fed in, and ScaledAdam through a median
re-estimate of its clip threshold."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.models.t2s import t2s_loss as j_t2s_loss
from gpt_sovits_tpu.train import s1_train as js1
from gpt_sovits_tpu.train.scaled_adam import scaled_adam as j_scaled_adam
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder, t2s_loss
from gpt_sovits_tpu_torch.train import s1_train
from gpt_sovits_tpu_torch.train.scaled_adam import ScaledAdam, scaled_adam_with_clip
from gpt_sovits_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

S1 = dict(vocab_size=41, phoneme_vocab_size=37, embedding_dim=32, hidden_dim=32, num_heads=4, ffn_dim=64,
          num_layers=2, eos_id=40, bert_dim=16, max_len=64)
GRAD_BAR = 1e-4  # relative L2, per tensor
UPDATE_BAR = 1e-3  # relative L2 of a parameter's change, and of each Adam moment
# the key third of in_proj_bias has a zero gradient in exact arithmetic
# (softmax is shift-invariant), so its float gradient is rounding noise and
# Adam's first step moves it by +-lr at that noise's sign; it is held to
# the bar in the Adam moments, where its size is that of the noise
KEY_BIAS = slice(S1["hidden_dim"], 2 * S1["hidden_dim"])


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def batch(seed, b=2, tx=8, ty=10):
    rng = np.random.default_rng(seed)
    x_lens = np.asarray([tx, tx - 3][:b], np.int32)
    y_lens = np.asarray([ty, ty - 4][:b], np.int32)
    return {
        "phoneme_ids": rng.integers(0, S1["phoneme_vocab_size"], (b, tx)).astype(np.int32),
        "phoneme_lens": x_lens,
        "semantic_ids": rng.integers(0, S1["vocab_size"] - 1, (b, ty)).astype(np.int32),
        "semantic_lens": y_lens,
        "bert_features": rng.standard_normal((b, tx, S1["bert_dim"])).astype(np.float32),
    }


def to_torch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_model():
    cfg = jconfig.S1Config(**S1)
    model = JT2S(cfg)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: model.init(k, method=JT2S.init_all))(jax.random.PRNGKey(0)))
    return cfg, model, params


@pytest.fixture(scope="module")
def jax_loss_grad(jax_model):
    """JAX's (loss, aux) and gradients on batch(1), jitted once."""
    _, model, params = jax_model
    b = {k: jnp.asarray(v) for k, v in batch(1).items()}
    fn = jax.jit(jax.value_and_grad(lambda p: j_t2s_loss(model, p, *b.values()), has_aux=True))
    return fn(params)


def port_model(jax_model):
    cfg, _, params = jax_model
    m = T2SDecoder(pconfig.S1Config(**S1))
    m.load_state_dict(weights.s1_from_jax(params, cfg), strict=True)
    return m


def named(tree, cfg) -> dict:
    """A JAX tree shaped like the parameters -> numpy under the port's names."""
    return {k: v.numpy() for k, v in weights.s1_from_jax({"params": jax.tree.map(np.asarray, tree)}, cfg).items()}


def check_update(model, before, opt_torch, new_params, inner_state, cfg):
    """Parameter changes and Adam moments of the port against JAX's."""
    j_new = named(new_params["params"], cfg)
    j_mu, j_nu = named(inner_state.mu, cfg), named(inner_state.nu, cfg)
    for name, p in model.named_parameters():
        d_port = (p.detach() - before[name]).numpy()
        d_jax = j_new[name] - before[name].numpy()
        if name.endswith("in_proj_bias"):
            d_port, d_jax = np.delete(d_port, np.arange(64)[KEY_BIAS]), np.delete(d_jax, np.arange(64)[KEY_BIAS])
        assert rel(d_port, d_jax) < UPDATE_BAR, (name, rel(d_port, d_jax))
        st = opt_torch.state[p]
        assert rel(st["exp_avg"].numpy(), j_mu[name]) < UPDATE_BAR, name
        assert rel(st["exp_avg_sq"].numpy(), j_nu[name]) < UPDATE_BAR, name


def test_t2s_loss_matches_jax(jax_model, jax_loss_grad):
    (j_loss, j_aux), _ = jax_loss_grad
    loss, aux = t2s_loss(port_model(jax_model), *to_torch(batch(1)).values())
    assert rel(loss.item(), float(j_loss)) < 1e-5
    assert float(aux["acc"]) == pytest.approx(float(j_aux["acc"]), abs=1e-7)
    assert float(aux["tokens"]) == float(j_aux["tokens"])
    np.testing.assert_allclose(aux["logp"].detach().numpy(), np.asarray(j_aux["logp"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(aux["mask"].numpy(), np.asarray(j_aux["mask"]))


def test_gradients_match_jax(jax_model, jax_loss_grad):
    cfg = jax_model[0]
    model = port_model(jax_model)
    t2s_loss(model, *to_torch(batch(1)).values())[0].backward()
    jg = named(jax_loss_grad[1]["params"], cfg)
    for name, p in model.named_parameters():
        assert rel(p.grad.numpy(), jg[name]) < GRAD_BAR, (name, rel(p.grad.numpy(), jg[name]))



def test_t2s_loss_in_float64_matches_jax(jax_model, jax_loss_grad):
    """A float64 copy of the model keeps float64 through t2s_loss (a
    reference run of the step; at_least_f32), and agrees with JAX's float32."""
    cfg = jax_model[0]
    model = port_model(jax_model).double()
    b = {k: v.double() if v.is_floating_point() else v for k, v in to_torch(batch(1)).items()}
    loss, aux = t2s_loss(model, *b.values())
    assert loss.dtype == aux["logp"].dtype == torch.float64
    assert rel(loss.item(), float(jax_loss_grad[0][0])) < 1e-5
    loss.backward()
    jg = named(jax_loss_grad[1]["params"], cfg)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float64
        assert rel(p.grad.numpy(), jg[name]) < GRAD_BAR, (name, rel(p.grad.numpy(), jg[name]))

@pytest.mark.parametrize("accum", [1, 4])
def test_adamw_update_matches_jax(jax_model, accum):
    """One AdamW update, from one micro-step or from the mean of 4
    accumulated ones: optax's weight decay 1e-4, the clip on the mean, the
    schedule counted in updates."""
    cfg, jmodel, params = jax_model
    batches = [batch(10 + i) for i in range(accum)]
    model = port_model(jax_model)
    opt = s1_train.make_optimizer(model.parameters(), pconfig.TrainConfig(grad_accum=accum, warmup_steps=4))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = s1_train.make_train_step(model, opt)
    updated = []
    for b in batches:
        m = step(to_torch(b))
        updated.append(opt.updates)
    assert updated == [0] * (accum - 1) + [1] and opt.mini_step == 0

    tc = jconfig.TrainConfig(grad_accum=accum, warmup_steps=4)
    jstate = js1.S1TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.array, params),
                              opt_state=js1.make_optimizer(tc).init(params["params"]))
    jstep = js1.make_train_step(jmodel, tc)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    assert rel(m["loss"].item(), float(jm["loss"])) < 1e-5
    inner = jstate.opt_state.inner_opt_state if accum > 1 else jstate.opt_state
    check_update(model, before, opt.inner, jstate.params, inner[1][0], cfg)


def test_schedule_matches_jax():
    """Within 5e-10 absolute, two float32 roundings of the peak lr 0.002 (2^-23
    x 0.002 = 2.4e-10): JAX evaluates (1e-5 - peak) * frac + peak in float32,
    which at frac = 1 cancels to 1.0000076e-5, where the port's float64 gives
    1e-5."""
    for cosine in (False, True):
        tc = pconfig.TrainConfig()
        ours = s1_train.make_schedule(tc, cosine=cosine)
        theirs = js1.make_schedule(jconfig.TrainConfig(), cosine=cosine)
        for n in (0, 1, 1999, 2000, 5000):
            assert ours(n) == pytest.approx(float(theirs(jnp.asarray(n))), rel=1e-6, abs=5e-10), (cosine, n)


def j_reject_draws(y_lens, key):
    """What the JAX make_reject_y draws from `key`."""
    k1, k2, _ = jax.random.split(key, 3)
    pos = jax.random.randint(k1, (len(y_lens),), 0, jnp.maximum(jnp.asarray(y_lens) - 1, 1))
    return np.array(pos), np.array(jax.random.bernoulli(k2, 0.5, (len(y_lens),)))


def test_make_reject_y_matches_jax():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 40, (6, 12)).astype(np.int32)
    lens = np.asarray([12, 8, 2, 1, 11, 5], np.int32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        j_rej, j_lens = js1.make_reject_y(jnp.asarray(y), jnp.asarray(lens), key)
        pos, mode = j_reject_draws(lens, key)
        rej, rej_lens = s1_train.make_reject_y(torch.from_numpy(y).long(), torch.from_numpy(lens).long(),
                                               pos=pos, mode=mode)
        np.testing.assert_array_equal(rej.numpy(), np.asarray(j_rej))
        np.testing.assert_array_equal(rej_lens.numpy(), np.asarray(j_lens))
    # the port's own draws: in range, a fair coin, from the generator alone
    g = torch.Generator().manual_seed(0)
    pos, mode = s1_train.draw_reject(torch.from_numpy(lens).long(), g)
    assert (pos >= 0).all() and (pos < torch.clamp_min(torch.from_numpy(lens).long() - 1, 1)).all()
    again = s1_train.draw_reject(torch.from_numpy(lens).long(), torch.Generator().manual_seed(0))
    assert torch.equal(pos, again[0]) and torch.equal(mode, again[1])


def test_dpo_update_matches_jax(jax_model):
    cfg, jmodel, params = jax_model
    b = batch(20)
    model = port_model(jax_model)
    opt = s1_train.make_optimizer(model.parameters(), pconfig.TrainConfig(grad_accum=1, warmup_steps=2))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    rng = jax.random.PRNGKey(9)
    reject = j_reject_draws(b["semantic_lens"], jax.random.fold_in(rng, 0))  # the JAX step's draw at step 0
    m = s1_train.make_train_step(model, opt, use_dpo=True)(to_torch(b), reject=reject)

    tc = jconfig.TrainConfig(grad_accum=1, warmup_steps=2)
    jstate = js1.S1TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.array, params),
                              opt_state=js1.make_optimizer(tc).init(params["params"]))
    jstate, jm = js1.make_train_step(jmodel, tc, use_dpo=True)(jstate, {k: jnp.asarray(v) for k, v in b.items()}, rng)
    assert rel(m["loss"].item(), float(jm["loss"])) < 1e-5
    check_update(model, before, opt.inner, jstate.params, jstate.opt_state[1][0], cfg)


def test_scaled_adam_matches_jax():
    """Six steps with a clip period of 4: the threshold re-estimates to
    2 x median at step 4, and the spike at step 5 is clipped by it."""
    rng = np.random.default_rng(5)
    p0 = {"w": rng.standard_normal((6, 5)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32),
          "s": np.asarray(0.7, np.float32)}
    grads = [{k: np.asarray(rng.standard_normal(v.shape) * (20.0 if i == 5 else 1.0), np.float32) for k, v in p0.items()}
             for i in range(6)]
    tx = j_scaled_adam(0.01, clipping_update_period=4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = ScaledAdam(list(tp.values()), 0.01, clipping_update_period=4)
    for i, g in enumerate(grads):
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    clip = opt.state["clip"]
    assert clip["count"] == 6
    assert float(clip["threshold"]) == pytest.approx(float(js.norm_threshold), rel=1e-5)
    np.testing.assert_allclose(clip["norm_buf"].numpy(), np.asarray(js.norm_buf), rtol=1e-5)
    assert float(js.norm_threshold) > 0 and np.isfinite(float(js.norm_threshold))
    # the ring, threshold and count travel in state_dict, through a file as a resumed run reads it
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    tq = {k: torch.nn.Parameter(p.detach().clone()) for k, p in tp.items()}
    again = ScaledAdam(list(tq.values()), 0.01, clipping_update_period=4)
    again.load_state_dict(torch.load(buf, weights_only=True))
    for o, ps in ((opt, tp), (again, tq)):
        for k, p in ps.items():
            p.grad = torch.from_numpy(grads[2][k].copy())
        o.step()
    for k in tp:
        assert torch.equal(tp[k], tq[k]), k


def test_scaled_adam_s1_step_matches_jax(jax_model):
    """The S1 trainer with optimizer="scaled_adam" (global-norm clip, then
    ScaledAdam at peak 0.025) and scaled_adam_with_clip."""
    cfg, jmodel, params = jax_model
    b = batch(30)
    model = port_model(jax_model)
    opt = s1_train.make_optimizer(model.parameters(), pconfig.TrainConfig(grad_accum=1, warmup_steps=2),
                                  optimizer="scaled_adam")
    s1_train.make_train_step(model, opt)(to_torch(b))
    tc = jconfig.TrainConfig(grad_accum=1, warmup_steps=2)
    jstate = js1.S1TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.array, params),
                              opt_state=js1.make_optimizer(tc, optimizer="scaled_adam").init(params["params"]))
    jstate, _ = js1.make_train_step(jmodel, tc, optimizer="scaled_adam")(
        jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    j_new = named(jstate.params["params"], cfg)
    before = weights.s1_from_jax(params, cfg)
    for name, p in model.named_parameters():
        d_port = (p.detach() - before[name]).numpy()
        d_jax = j_new[name] - before[name].numpy()
        if name.endswith("in_proj_bias"):
            d_port, d_jax = np.delete(d_port, np.arange(64)[KEY_BIAS]), np.delete(d_jax, np.arange(64)[KEY_BIAS])
        assert rel(d_port, d_jax) < UPDATE_BAR, (name, rel(d_port, d_jax))

    w = torch.nn.Parameter(torch.ones(3, 3))
    clipped = scaled_adam_with_clip([w], 0.05, grad_clip=1.0)
    w.grad = torch.full((3, 3), 10.0)
    clipped.step()
    jw = {"w": jnp.ones((3, 3))}
    from gpt_sovits_tpu.train.scaled_adam import scaled_adam_with_clip as j_with_clip

    jtx = j_with_clip(0.05, grad_clip=1.0)
    upd, _ = jtx.update({"w": jnp.full((3, 3), 10.0)}, jtx.init(jw), jw)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(optax.apply_updates(jw, upd)["w"]), rtol=1e-6)
