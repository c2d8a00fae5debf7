"""S2 GAN training in the port (models/vits.py forward and PosteriorEncoder,
vits_modules.py's forward flow, models/discriminators.py,
train/s2_train.py) held against the JAX package on the CPU at tiny widths:
the training forward with JAX's noise and segment starts, the
discriminators and losses, vq_ema_update, one whole G+D step (losses,
gradients, post-update parameters of the base, text and frozen groups) and
the learning rate's continuous decay."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpt_sovits_tpu.dsp.mel import mel_spectrogram as j_mel
from gpt_sovits_tpu.dsp.mel import spec_to_mel as j_spec_to_mel
from gpt_sovits_tpu.models import discriminators as jd
from gpt_sovits_tpu.train import s2_train as js2
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.dsp.mel import mel_spectrogram, spec_to_mel
from gpt_sovits_tpu_torch.models import discriminators as pd
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.train import s2_train
from gpt_sovits_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

S2 = dict(version="v2ProPlus", spec_channels=65, segment_size=8, inter_channels=16, hidden_channels=16,
          filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, upsample_rates=(8, 8),
          upsample_initial_channel=32, upsample_kernel_sizes=(16, 16), resblock_kernel_sizes=(3,),
          resblock_dilation_sizes=((1, 3),), gin_channels=16, mrte_hidden=16, ssl_dim=16, n_codes=17, sv_dim=24)
MEL = dict(sampling_rate=8000, n_fft=128, win_size=128, hop_size=64, num_mels=13)
B, TSPEC, TT = 2, 20, 6
GRAD_BAR = 1e-4  # relative L2, per tensor
UPDATE_BAR = 1e-3  # relative L2 of a parameter's change
# biases whose gradient is zero in exact arithmetic (a key bias shifts every
# score of a softmax row alike): Adam's first step moves them by +-lr at the
# sign of their rounding noise
ZERO_GRAD = (".conv_k.bias", ".w_ks.bias")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def batch_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "ssl": rng.standard_normal((B, TSPEC * 2, S2["ssl_dim"])).astype(np.float32),
        "spec": (rng.standard_normal((B, TSPEC, S2["spec_channels"])) * 0.3 + 1.0).astype(np.float32),
        "spec_lengths": np.asarray([TSPEC, TSPEC - 3], np.int32),
        "wav": (rng.standard_normal((B, TSPEC * MEL["hop_size"], 1)) * 0.1).astype(np.float32),
        "text": rng.integers(0, 732, (B, TT)).astype(np.int32),
        "text_lengths": np.asarray([TT, TT - 2], np.int32),
        "sv_emb": rng.standard_normal((B, S2["sv_dim"])).astype(np.float32),
    }


def to_torch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in b.items()}


def seeded_params(init_fn, seed: int) -> dict:
    """A flax parameter tree of init_fn's shapes, filled from a numpy seed
    (kernels at 1/sqrt(fan-in), norms at 1, codebooks uniform): shapes come
    from tracing, which compiles nothing, where flax's own eager init of the
    whole GAN takes most of a minute on the CPU."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        if name in ("alpha_text", "alpha_audio", "prelu_alpha"):
            return np.full(leaf.shape, 0.25, np.float32)
        if name == "embed":
            return rng.uniform(-1, 1, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" else 1
        std = 0.1 if name == "bias" else (0.5 if name.startswith("emb") else fan_in**-0.5)
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn))


@pytest.fixture(scope="module")
def setup():
    cfg = jconfig.S2Config(**S2)
    tc = jconfig.TrainConfig(batch_size=B)
    b = {k: jnp.asarray(v) for k, v in batch_np().items()}
    gen = js2.SynthesizerTrn(cfg)
    disc = jd.MultiPeriodDiscriminator(jd_periods(cfg))
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1), "slice": jax.random.PRNGKey(2)}
    params_g = seeded_params(lambda: gen.init(keys, b["ssl"], b["spec"], b["spec_lengths"], b["text"],
                                              b["text_lengths"], sv_emb=b["sv_emb"],
                                              method=js2.SynthesizerTrn.init_all), 1)
    seg = b["wav"][:, :64]
    params_d = seeded_params(lambda: disc.init(jax.random.PRNGKey(3), seg, seg), 2)
    return cfg, tc, gen, disc, params_g, params_d


def jd_periods(cfg):
    return (2, 3, 5, 7, 11, 17, 23) if cfg.is_pro else (2, 3, 5, 7, 11)


def plain(sd: dict) -> dict:
    """A state dict with weight-norm pairs -> plain weights: the pairs are
    written with v = w exactly (weights.py `_conv`), so v is the weight (and a
    gradient tree maps the same way)."""
    return {k.replace(".weight_v", ".weight"): v for k, v in sd.items() if not k.endswith(".weight_g")}


def port_models(setup):
    cfg, _, _, disc, params_g, params_d = setup
    gen = SynthesizerTrn(pconfig.S2Config(**S2), posterior=True)
    gen.load_state_dict(plain(weights.s2_from_jax(params_g, cfg)), strict=True)
    d = pd.MultiPeriodDiscriminator(disc.periods)
    d.load_state_dict(weights.d_from_jax(params_d, disc.periods), strict=True)
    return gen, d


def draws(rng, step, spec_lengths, t):
    """The JAX step's noise and segment starts at `step`."""
    rng_noise, rng_slice = jax.random.split(jax.random.fold_in(rng, step))
    noise = np.array(jax.random.normal(rng_noise, (B, t, S2["inter_channels"])))
    max_starts = jnp.maximum(jnp.asarray(spec_lengths) - S2["segment_size"], 0)
    starts = (jax.random.uniform(rng_slice, (B,)) * (max_starts + 1)).astype(jnp.int32)
    return rng_noise, rng_slice, noise, np.array(starts)


def test_training_forward_matches_jax(setup):
    cfg, _, jgen, _, params_g, _ = setup
    bn = batch_np()
    rng_noise, rng_slice, noise, starts = draws(jax.random.PRNGKey(3), 0, bn["spec_lengths"], TSPEC)
    jb = {k: jnp.asarray(v) for k, v in bn.items()}
    jout = jax.jit(lambda p: jgen.apply(p, jb["ssl"], jb["spec"], jb["spec_lengths"], jb["text"], jb["text_lengths"],
                                        rngs_noise=rng_noise, rng_slice=rng_slice, sv_emb=jb["sv_emb"]))(params_g)
    gen, _ = port_models(setup)
    tb = to_torch(bn)
    with torch.no_grad():
        out = gen(tb["ssl"], tb["spec"], tb["spec_lengths"], tb["text"], tb["text_lengths"], sv_emb=tb["sv_emb"],
                  noise=noise, ids_slice=starts)
    np.testing.assert_array_equal(out["ids_slice"].numpy(), np.asarray(jout["ids_slice"]))
    for k in ("z", "z_p", "m_p", "logs_p", "m_q", "logs_q", "wav_hat", "y_mask"):
        assert rel(out[k].numpy(), np.asarray(jout[k])) < 1e-5, (k, rel(out[k].numpy(), np.asarray(jout[k])))
    assert rel(out["commit_loss"].item(), float(jout["commit_loss"])) < 1e-5
    # the port draws its own noise and starts from a CPU generator, reproducibly
    g = lambda: torch.Generator().manual_seed(7)
    with torch.no_grad():
        a = gen(tb["ssl"], tb["spec"], tb["spec_lengths"], tb["text"], tb["text_lengths"], sv_emb=tb["sv_emb"],
                generator=g())
        b = gen(tb["ssl"], tb["spec"], tb["spec_lengths"], tb["text"], tb["text_lengths"], sv_emb=tb["sv_emb"],
                generator=g())
    assert torch.equal(a["z"], b["z"]) and torch.equal(a["ids_slice"], b["ids_slice"])
    assert (a["ids_slice"] <= torch.clamp_min(tb["spec_lengths"] - S2["segment_size"], 0)).all()


def test_discriminators_and_losses_match_jax(setup):
    _, _, _, jdisc, _, params_d = setup
    rng = np.random.default_rng(4)
    y, y_hat = (rng.standard_normal((B, 256, 1)).astype(np.float32) * 0.3 for _ in range(2))
    jr, jg, jfr, jfg = jax.jit(jdisc.apply)(params_d, jnp.asarray(y), jnp.asarray(y_hat))
    _, d = port_models(setup)
    with torch.no_grad():
        r, g, fr, fg = d(torch.from_numpy(y), torch.from_numpy(y_hat))
    assert len(r) == 1 + len(pd.PERIODS_PRO)
    for a, b in zip(r + g, jr + jg):
        assert rel(a.numpy(), np.asarray(b)) < 1e-5
    for maps, jmaps in ((fr, jfr), (fg, jfg)):
        for dm, jdm in zip(maps, jmaps):
            for a, b in zip(dm, jdm):  # channels-first against feature-last
                assert rel(a.numpy(), np.moveaxis(np.asarray(b), -1, 1)) < 1e-5
    assert rel(pd.feature_loss(fr, fg).item(), float(jd.feature_loss(jfr, jfg))) < 1e-5
    for ours, theirs in ((pd.discriminator_loss(r, g), jd.discriminator_loss(jr, jg)),
                         (pd.generator_loss(g), jd.generator_loss(jg))):
        assert rel(ours[0].item(), float(theirs[0])) < 1e-5
        for a, b in zip(ours[1], theirs[1]):
            assert rel(a.item(), float(b)) < 1e-5
    z_p, logs_q, m_p, logs_p = (rng.standard_normal((B, 9, 4)).astype(np.float32) * 0.5 for _ in range(4))
    mask = (np.arange(9)[None, :, None] < np.asarray([9, 6])[:, None, None]).astype(np.float32)
    args = (z_p, logs_q, m_p, logs_p, mask)
    assert rel(pd.kl_loss(*map(torch.from_numpy, args)).item(), float(jd.kl_loss(*map(jnp.asarray, args)))) < 1e-5

    # the multi-resolution discriminator (BigVGAN training) at small resolutions
    res = ((128, 32, 64), (64, 16, 48))
    mrd = jd.MultiResolutionDiscriminator(res)
    mp = seeded_params(lambda: mrd.init(jax.random.PRNGKey(2), jnp.asarray(y), jnp.asarray(y_hat)), 3)
    jr, jg, _, jfg = jax.jit(mrd.apply)(mp, jnp.asarray(y), jnp.asarray(y_hat))
    pm = pd.MultiResolutionDiscriminator(res)
    pm.load_state_dict(weights.mrd_from_jax(mp, res), strict=True)
    with torch.no_grad():
        r, g, _, fg = pm(torch.from_numpy(y), torch.from_numpy(y_hat))
    for a, b in zip(r + g, jr + jg):
        assert rel(a.numpy(), np.asarray(b)) < 1e-5
    assert rel(fg[1][2].numpy(), np.moveaxis(np.asarray(jfg[1][2]), -1, 1)) < 1e-5


def test_mel_carries_gradients_and_matches_jax():
    mcfg = pconfig.MelConfig(**MEL)
    rng = np.random.default_rng(6)
    y = rng.standard_normal((2, 640)).astype(np.float32) * 0.2
    w = torch.from_numpy(y).requires_grad_(True)
    m = mel_spectrogram(w, mcfg)
    jm = j_mel(jnp.asarray(y), jconfig.MelConfig(**MEL))
    assert rel(m.detach().numpy(), np.asarray(jm)) < 1e-5
    jgrad = jax.grad(lambda v: jnp.sum(j_mel(v, jconfig.MelConfig(**MEL)) ** 2))(jnp.asarray(y))
    (m**2).sum().backward()
    assert rel(w.grad.numpy(), np.asarray(jgrad)) < 1e-4
    spec = np.abs(rng.standard_normal((2, 65, 7))).astype(np.float32)
    spec[0, :, 0] = 0.0  # below the 1e-5 clip: no gradient there
    s = torch.from_numpy(spec).requires_grad_(True)
    spec_to_mel(s, mcfg).sum().backward()
    jsg = jax.grad(lambda v: jnp.sum(j_spec_to_mel(v, jconfig.MelConfig(**MEL))))(jnp.asarray(spec))
    assert rel(s.grad.numpy(), np.asarray(jsg)) < 1e-5


def test_vq_ema_update_matches_jax():
    rng = np.random.default_rng(8)
    embed = rng.standard_normal((8, 4)).astype(np.float32)
    je, js = jnp.asarray(embed), js2.VQEmaState.init(jnp.asarray(embed))
    pe, ps = torch.from_numpy(embed), s2_train.VQEmaState.init(torch.from_numpy(embed))
    for _ in range(3):
        x = rng.standard_normal((32, 4)).astype(np.float32)
        codes = rng.integers(0, 8, 32).astype(np.int32)
        je, js = js2.vq_ema_update(je, js, jnp.asarray(x), jnp.asarray(codes), decay=0.9)
        pe, ps = s2_train.vq_ema_update(pe, ps, torch.from_numpy(x), torch.from_numpy(codes).long(), decay=0.9)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ps.cluster_size.numpy(), np.asarray(js.cluster_size), rtol=1e-6)
    np.testing.assert_allclose(ps.embed_avg.numpy(), np.asarray(js.embed_avg), rtol=1e-5, atol=1e-6)


def test_step_in_float64(setup):
    """Float64 copies of G and D keep float64 through the whole G+D step (the
    mel, the GAN losses, the posterior noise: at_least_f32), and their
    gradients agree with the float32 step's."""
    bn = batch_np(2)
    noise = np.random.default_rng(3).standard_normal((B, TSPEC, S2["inter_channels"])).astype(np.float32)
    starts = np.asarray([4, 1])
    ptc, mcfg = pconfig.TrainConfig(batch_size=B), pconfig.MelConfig(**MEL)
    grads, metrics = {}, {}
    for dt in (torch.float32, torch.float64):
        gen, d = (m.to(dt) for m in port_models(setup))
        tb = {k: v.to(dt) if v.is_floating_point() else v for k, v in to_torch(bn).items()}
        step = s2_train.make_train_step(gen, d, s2_train.make_optimizer_g(gen, ptc, 4),
                                        s2_train.make_optimizer_d(d, ptc, 4), ptc, mcfg)
        metrics[dt] = step(tb, noise=noise, ids_slice=starts)
        grads[dt] = {n: p.grad for m in (gen, d) for n, p in m.named_parameters() if p.grad is not None}
    assert all(v.dtype == torch.float64 for v in metrics[torch.float64].values())
    for k, v in metrics[torch.float32].items():
        assert rel(v.item(), metrics[torch.float64][k].item()) < 1e-5, k
    assert grads[torch.float32].keys() == grads[torch.float64].keys()
    for name, g64 in grads[torch.float64].items():
        assert g64.dtype == torch.float64, name
        if not name.endswith(ZERO_GRAD):
            assert rel(grads[torch.float32][name].numpy(), g64.numpy()) < GRAD_BAR, name

def label_like_reference(params, freeze_quantizer: bool):
    """JAX's groups, but with the reference's frozen set: only the top-level
    ssl_proj and quantizer (models.py `requires_grad_(False)`). JAX's labels
    freeze every "ssl_proj" on a parameter's path, enc_p's too (s2_train.py:91-103;
    ROADMAP queue 3); the port trains enc_p.ssl_proj as the reference does."""
    labels = JAX_LABELS(params, freeze_quantizer)
    return jax.tree_util.tree_map_with_path(
        lambda path, lab: "base" if lab == "frozen" and path[0].key not in js2.FROZEN_MODULES else lab, labels)


JAX_LABELS = js2._label_params_g


def test_gd_step_matches_jax(setup, monkeypatch):
    """One whole step: the D update on the detached fake, then the G loss
    against the updated D; losses, every gradient, and the parameters after
    the update, group by group. JAX's step runs with the reference's frozen
    set (label_like_reference), so enc_p.ssl_proj is held like any other."""
    monkeypatch.setattr(js2, "_label_params_g", label_like_reference)
    cfg, tc, jgen, jdisc, params_g, params_d = setup
    mcfg = jconfig.MelConfig(**MEL)
    spe = 4
    bn = batch_np(1)
    jb = {k: jnp.asarray(v) for k, v in bn.items()}
    rng = jax.random.PRNGKey(5)
    rng_noise, rng_slice, noise, starts = draws(rng, 0, bn["spec_lengths"], TSPEC)
    jstate = js2.S2TrainState(
        step=jnp.zeros((), jnp.int32), params_g=jax.tree.map(jnp.array, params_g),
        params_d=jax.tree.map(jnp.array, params_d),
        opt_g=js2.make_optimizer_g(tc, cfg, spe).init(params_g["params"]),
        opt_d=js2.make_optimizer_d(tc, spe).init(params_d["params"]))
    jstep = js2.make_train_step(jgen, jdisc, tc, mcfg, steps_per_epoch=spe)
    jnew, jm = jstep(jstate, jb, rng)

    # JAX's gradients, read from its first Adam moment: mu = (1 - b1) * g after one update
    b1 = tc.betas[0]
    jgd = jax.tree.map(lambda m: np.asarray(m) / (1 - b1), jnew.opt_d[0].mu)
    masked = lambda x: isinstance(x, optax.MaskedNode)
    mus = [jnew.opt_g.inner_states[lab].inner_state[0].mu for lab in ("base", "text")]
    jgg = jax.tree.map(lambda a, b: np.asarray(b if masked(a) else a) / (1 - b1) if not (masked(a) and masked(b))
                       else None, *mus, is_leaf=masked)

    gen, d = port_models(setup)
    ptc = pconfig.TrainConfig(batch_size=B)
    opt_g, opt_d = s2_train.make_optimizer_g(gen, ptc, spe), s2_train.make_optimizer_d(d, ptc, spe)
    before_g = {k: v.detach().clone() for k, v in gen.named_parameters()}
    before_d = {k: v.detach().clone() for k, v in d.named_parameters()}
    m = s2_train.make_train_step(gen, d, opt_g, opt_d, ptc, pconfig.MelConfig(**MEL))(
        to_torch(bn), noise=noise, ids_slice=starts)
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv", "loss_commit"):
        assert rel(m[k].item(), float(jm[k])) < 1e-5, (k, m[k].item(), float(jm[k]))

    labels = s2_train.label_params_g(gen, True)
    jg_named = {k: v.numpy() for k, v in plain(weights.s2_from_jax(
        {"params": jax.tree.map(lambda g, p: np.zeros_like(p) if g is None else g, jgg, params_g["params"],
                                is_leaf=lambda x: x is None)}, cfg)).items()}
    jd_named = {k: v.numpy() for k, v in weights.d_from_jax({"params": jgd}, jdisc.periods).items()}
    for name, p in d.named_parameters():
        assert rel(p.grad.numpy(), jd_named[name]) < GRAD_BAR, (name, rel(p.grad.numpy(), jd_named[name]))
    for name, p in gen.named_parameters():
        if labels[name] == "frozen":  # no gradient, as the reference's requires_grad_(False)
            assert p.grad is None and not p.requires_grad, name
            continue
        if name.endswith(ZERO_GRAD):
            continue  # a zero gradient's rounding noise
        assert rel(p.grad.numpy(), jg_named[name]) < GRAD_BAR, (name, rel(p.grad.numpy(), jg_named[name]))

    new_g = {k: v.numpy() for k, v in plain(weights.s2_from_jax(jax.tree.map(np.asarray, jnew.params_g), cfg)).items()}
    new_d = {k: v.numpy() for k, v in weights.d_from_jax(jax.tree.map(np.asarray, jnew.params_d),
                                                          jdisc.periods).items()}
    seen = set()
    for model, before, new in ((gen, before_g, new_g), (d, before_d, new_d)):
        for name, p in model.named_parameters():
            d_port, d_jax = (p.detach() - before[name]).numpy(), new[name] - before[name].numpy()
            group = labels.get(name, "disc")
            seen.add(group)
            if group == "frozen":
                assert not d_port.any() and not d_jax.any(), name
            elif not name.endswith(ZERO_GRAD):
                assert rel(d_port, d_jax) < UPDATE_BAR, (name, group, rel(d_port, d_jax))
    assert seen == {"base", "text", "frozen", "disc"}
    assert labels["enc_p.ssl_proj.weight"] == "base" and labels["ssl_proj.weight"] == "frozen"


def test_lr_decays_continuously_like_optax():
    tc = pconfig.TrainConfig()
    gen = SynthesizerTrn(pconfig.S2Config(**S2), posterior=True)
    opt = s2_train.make_optimizer_g(gen, tc, steps_per_epoch=10)
    for n in (0, 15, 37):  # 1.5 epochs at 10 steps an epoch, and more
        sched = optax.exponential_decay(tc.learning_rate, 10, tc.lr_decay)
        text = optax.exponential_decay(tc.learning_rate * tc.text_low_lr_rate, 10, tc.lr_decay)
        assert opt.group_lrs(n) == pytest.approx([float(sched(n)), float(text(n))], rel=1e-6)
    assert opt.group_lrs(10)[0] < opt.group_lrs(0)[0]
    assert opt.group_lrs(15)[0] < opt.group_lrs(10)[0]  # continuous, not a staircase
    # the groups: frozen parameters take no update and no weight decay
    names = {id(p): n for n, p in gen.named_parameters()}
    in_opt = {names[id(p)] for g in opt.inner.param_groups for p in g["params"]}
    frozen = {n for n, lab in s2_train.label_params_g(gen, True).items() if lab == "frozen"}
    assert frozen and not (frozen & in_opt) and in_opt | frozen == set(names.values())
    assert [g.get("lr_scale", 1.0) for g in opt.inner.param_groups] == [1.0, tc.text_low_lr_rate]
    # a step sets each group's lr from the update count: 15 updates in, 1.5 epochs
    opt.updates = 15
    for p in gen.parameters():
        p.grad = torch.zeros_like(p) if p.requires_grad else None
    opt.step()
    sched = optax.exponential_decay(tc.learning_rate, 10, tc.lr_decay)
    assert [g["lr"] for g in opt.inner.param_groups] == pytest.approx(
        [float(sched(15)), float(sched(15)) * tc.text_low_lr_rate], rel=1e-6)
