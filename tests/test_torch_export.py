"""The port's pt2 export (gpt_sovits_tpu_torch/utils/export.py) against the
JAX package's StableHLO export (gpt_sovits_tpu/utils/export.py) on the CPU,
at the JAX tests' tiny configs, with weights drawn with numpy and carried
across by weights.py.

Each pt2 artifact, loaded back with `load_exported(device="cpu")`, is held
against the JAX model's direct apply and against JAX's own artifact at
tests/test_export.py's tolerance (1e-5). The v3/v4 artifacts are held to
1e-5 against the port's own direct call, and against JAX (direct and
artifact) at the bars tests/test_torch_v4.py sets for those modules (their
random-weight outputs reach ~10 and amplify float32 rounding); the CFM's
takes JAX's noise draw for seed 7. The functional S1 step equals `decode_step`; `decode` with
prior noise equals JAX's with the same draw. Kernel wrappers refuse a
traced input on the card (a mocked CUDA route here). Blobs stay in memory.
"""

import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from gpt_sovits_tpu.models.bigvgan import BigVGAN as JBigVGAN, BigVGANConfig as JBigVGANConfig
from gpt_sovits_tpu.models.dit import DiT as JDiT
from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3 as JV3, cfm_inference as j_cfm_inference
from gpt_sovits_tpu.models.vits import SynthesizerTrn as JSynth
from gpt_sovits_tpu.utils import export as jex
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3, cfm_inference
from gpt_sovits_tpu_torch.models.vits import Generator, SynthesizerTrn
from gpt_sovits_tpu_torch.ops import decode_step as ds
from gpt_sovits_tpu_torch.ops import qflash as qf
from gpt_sovits_tpu_torch.ops import qmatmul as qm
from gpt_sovits_tpu_torch.ops import snake_aa as sa
from gpt_sovits_tpu_torch.utils import config
from gpt_sovits_tpu_torch.utils import export as ex

from test_t2s import TINY as S1_TINY
from test_v3 import V3_TINY
from test_vits import TINY as S2_TINY

torch.set_num_threads(1)
ATOL = 1e-5  # tests/test_export.py's
KEYS = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(0), "slice": jax.random.PRNGKey(0)}
# tests/test_bigvgan.py's TINY, the JAX ONNX test's vocoder
BIGVGAN_TINY = dict(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
                    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),))


def drawn(init, seed: int, std: float = 0.2):
    """Parameters of the flax model's shapes drawn with numpy (as JAX
    arrays, which the JAX modules index with traced ids)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: jnp.asarray((std * rng.standard_normal(s.shape)).astype(np.float32)),
                        jax.eval_shape(init))


def drawn_vocoder(init, seed: int):
    """tests/test_torch_bigvgan.py's draw: kernels of unit gain and
    per-channel snake parameters, so that the clamped output is not
    saturated."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1])
        std = 0.3 if ("alpha" in name or "beta" in name) else 0.05
        if "kernel" in name:
            std = 0.7 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray((std * rng.standard_normal(s.shape)).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def port_cfg(jcfg, cls):
    return cls(**dataclasses.asdict(jcfg))


def japply(jm, params, *args, **kw):
    """The JAX model's direct apply, jitted (op-by-op dispatch compiles each
    primitive on its own: ~4x slower on this CPU for the same values)."""
    return jax.jit(lambda p, *a: jm.apply(p, *a, **kw))(params, *map(jnp.asarray, args))


@pytest.fixture(scope="module")
def s2():
    return _s2_models()


@functools.cache
def _s2_models():
    """Built once a process: tests/test_torch_onnx_export.py takes the same
    models (no test writes to them)."""
    jm = JSynth(S2_TINY)
    params = drawn(lambda: jm.init(KEYS, jnp.zeros((1, 48, S2_TINY.ssl_dim)), jnp.zeros((1, 24, S2_TINY.spec_channels)),
                                   jnp.asarray([24]), jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
                                   method=JSynth.init_all), 0, 0.1)
    pm = SynthesizerTrn(port_cfg(S2_TINY, config.S2Config))
    pm.load_state_dict(weights.s2_from_jax(params, pm.cfg))
    rng = np.random.default_rng(1)
    args = (rng.integers(0, S2_TINY.n_codes, (1, 12)).astype(np.int32), np.asarray([12], np.int32),
            rng.integers(1, S2_TINY.phoneme_vocab_size, (1, 8)).astype(np.int32), np.asarray([8], np.int32),
            (rng.standard_normal((1, 16, S2_TINY.spec_channels)) * 0.3).astype(np.float32), np.asarray([16], np.int32))
    return jm, params, pm.eval(), args


@functools.cache
def s2_jax_decode() -> np.ndarray:
    """The JAX model's direct decode of _s2_models' inputs, once a process."""
    jm, params, _, args = _s2_models()
    return np.asarray(japply(jm, params, *args, method=JSynth.decode))


@pytest.fixture(scope="module")
def s1():
    jm = JT2S(S1_TINY)
    params = drawn(lambda: jm.init(jax.random.PRNGKey(0), method=JT2S.init_all), 2)
    pm = T2SDecoder(port_cfg(S1_TINY, config.S1Config))
    pm.load_state_dict(weights.s1_from_jax(params, pm.cfg))
    return jm, params, pm.eval()


def s1_step_inputs(cfg, b: int, t: int, slots, seed: int):
    rng = np.random.default_rng(seed)
    h, dh = cfg.num_heads, cfg.hidden_dim // cfg.num_heads
    e = (rng.standard_normal((b, 1, cfg.embedding_dim)) * 0.5).astype(np.float32)
    k, v = ((rng.standard_normal((cfg.num_layers, b, t, h, dh)) * 0.5).astype(np.float32) for _ in range(2))
    valid = np.arange(t)[None, :] <= np.broadcast_to(np.asarray(slots), (b,))[:, None]
    return e, k, v, valid


def test_export_roundtrip_simple():
    fn = lambda x, w: torch.tanh(x @ w)  # noqa: E731
    x, w = torch.ones((2, 4)), torch.ones((4, 3)) * 0.1
    blob = ex.export_fn(fn, (x, w))
    assert isinstance(blob, bytes) and len(blob) > 100
    restored = ex.load_exported(blob, device="cpu")
    np.testing.assert_allclose(restored(x, w).numpy(), fn(x, w).numpy(), atol=1e-6)


def test_export_s2_decode(s2):
    jm, params, pm, args = s2
    want = s2_jax_decode()
    got = ex.load_exported(ex.export_s2_decode(pm, b=1, tc=12, tt=8, tr=16), device="cpu")(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    jax_blob = jex.export_s2_decode(jm, params, b=1, tc=12, tt=8, tr=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jex.load_exported(jax_blob)(*args)), atol=ATOL)


def test_decode_with_prior_noise_is_jaxs(s2):
    jm, params, pm, args = s2
    key = jax.random.PRNGKey(3)
    want = japply(jm, params, *args, noise_rng=key, noise_scale=0.7, method=JSynth.decode)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (1, 24, S2_TINY.inter_channels))))
    with torch.no_grad():
        got = pm.decode(*map(torch.from_numpy, args), noise=noise, noise_scale=0.7)
        plain = pm.decode(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not torch.allclose(got, plain)


def test_export_s1_step(s1):
    jm, params, pm = s1
    t, slot = 64, 10
    e, k, v, valid = s1_step_inputs(S1_TINY, 1, t, slot, 3)
    blob = ex.export_s1_step(pm, b=1, t_cache=t)
    outs = ex.load_exported(blob, device="cpu")(e, k, v, valid, np.asarray(slot, np.int32))
    want = japply(jm, params, e, k, v, valid, jnp.asarray(slot, jnp.int32), method=JT2S.decode_step)
    jax_outs = jex.load_exported(jex.export_s1_step(jm, params, b=1, t_cache=t))(e, k, v, valid,
                                                                                jnp.asarray(slot, jnp.int32))
    for got, w, jw in zip(outs, want, jax_outs):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jw), atol=ATOL)
    # the returned caches hold the fresh K/V at the slot and the inputs elsewhere
    new_k = outs[1].numpy()
    keep = np.arange(t) != slot
    np.testing.assert_array_equal(new_k[:, :, keep], k[:, :, keep])
    assert not np.allclose(new_k[:, :, slot], k[:, :, slot])


@pytest.mark.parametrize("slots", [7, [7, 3]], ids=["one_slot", "a_slot_a_row"])
def test_functional_step_equals_decode_step(s1, slots):
    _, _, pm = s1
    b = 1 if isinstance(slots, int) else len(slots)
    e, k, v, valid = map(torch.from_numpy, s1_step_inputs(S1_TINY, b, 32, slots, 4))
    k0, v0 = k.clone(), v.clone()
    with torch.no_grad():
        logits, new_k, new_v = pm.decode_step_functional(e, k, v, valid, torch.tensor(slots, dtype=torch.int32))
        assert torch.equal(k, k0) and torch.equal(v, v0)  # no input written
        want = pm.decode_step(e, k, v, valid, slots)  # writes k, v in place
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(new_k, k) and torch.equal(new_v, v)


@pytest.fixture(scope="module")
def v3():
    jm = JV3(V3_TINY)
    b, ts, tm, tt = 1, 24, 45, 6
    params = drawn(lambda: jm.init(
        KEYS, jnp.zeros((b, ts, V3_TINY.ssl_dim)), jnp.zeros((b, ts, V3_TINY.spec_channels)), jnp.asarray([ts]),
        jnp.zeros((b, tm, V3_TINY.cfm_mel_channels)), jnp.asarray([tm]), jnp.zeros((b, tt), jnp.int32),
        jnp.asarray([tt]), method=JV3.init_all), 5, 0.1)
    pm = SynthesizerTrnV3(port_cfg(V3_TINY, config.S2Config))
    pm.load_state_dict(weights.s2v3_from_jax(params, pm.cfg))
    return jm, params, pm.eval()


def assert_encp(got, want):
    """tests/test_torch_v4.py's bars for decode_encp against JAX: f32 through
    ~20 random-weight layers amplifies rounding, so fea is held to 2e-3 of its
    scale (1e-3 in mean), ge to 1e-5 of its scale, mel_len exactly."""
    (f, g, m), (fj, gj, mj) = [np.asarray(x) for x in got], [np.asarray(x) for x in want]
    np.testing.assert_array_equal(m, mj)
    np.testing.assert_allclose(g, gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max())
    n = int(mj[0])
    np.testing.assert_allclose(f[:, :n], fj[:, :n], rtol=1e-3, atol=2e-3 * np.abs(fj).max())
    assert np.abs(f[:, :n] - fj[:, :n]).mean() / np.abs(fj[:, :n]).mean() < 1e-3


def assert_cfm(got, want):
    """tests/test_torch_v4.py's bar for the Euler loop against JAX."""
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


def test_export_v3_decode_and_cfm(v3):
    """Each artifact equals the port's direct call within 1e-5 (the JAX
    test's bar for an artifact against its model); port against JAX, both
    ways (direct and artifact), at tests/test_torch_v4.py's bars."""
    jm, params, pm = v3
    rng = np.random.default_rng(6)
    tc, tt, tr = 12, 6, 24
    args = (rng.integers(0, V3_TINY.n_codes, (1, tc)).astype(np.int32), np.asarray([tc], np.int32),
            rng.integers(1, 300, (1, tt)).astype(np.int32), np.asarray([tt], np.int32),
            (rng.standard_normal((1, tr, V3_TINY.spec_channels)) * 0.3).astype(np.float32), np.asarray([tr], np.int32))
    got = ex.load_exported(ex.export_v3_decode(pm, b=1, tc=tc, tt=tt, tr=tr), device="cpu")(*args)
    with torch.no_grad():
        eager = pm.decode_encp(*map(torch.from_numpy, args))
    for g, e in zip(got, eager):
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=ATOL)
    assert_encp(got, japply(jm, params, *args, method=JV3.decode_encp))
    assert_encp(got, jex.load_exported(jex.export_v3_decode(jm, params, b=1, tc=tc, tt=tt, tr=tr))(*args))

    # the Euler loop, its noise JAX's draw for seed 7
    t, tp, steps, seed = 48, 16, 2, 7
    mel = jm.dit_config.mel_dim
    mu = (rng.standard_normal((1, t, jm.dit_config.text_dim)) * 0.5).astype(np.float32)
    prompt = (rng.standard_normal((1, tp, mel)) * 0.3).astype(np.float32)
    x_lens = np.asarray([t], np.int32)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(jnp.uint32(seed)), (1, t, mel)))
    got = ex.load_exported(ex.export_cfm(pm, b=1, t=t, tp=tp, n_steps=steps), device="cpu")(mu, x_lens, prompt, noise)
    with torch.no_grad():
        eager = cfm_inference(pm.cfm.estimator, *map(torch.from_numpy, (mu, x_lens, prompt)),
                              noise=torch.from_numpy(noise), n_steps=steps)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), atol=ATOL)
    dit_params = {"params": params["params"]["cfm"]["estimator"]}
    want = jax.jit(lambda p, *a: j_cfm_inference(JDiT(jm.dit_config), p, *a, n_steps=steps))(
        dit_params, jnp.asarray(mu), jnp.asarray(x_lens), jnp.asarray(prompt), jax.random.PRNGKey(jnp.uint32(seed)))
    assert_cfm(got.numpy(), np.asarray(want))
    jax_got = jex.load_exported(jex.export_cfm(jm, params, b=1, t=t, tp=tp, n_steps=steps))(
        mu, x_lens, prompt, jnp.asarray(seed, jnp.uint32))
    assert_cfm(got.numpy(), np.asarray(jax_got))


def test_export_vocoders():
    jm = JBigVGAN(JBigVGANConfig(**BIGVGAN_TINY))
    mel = (np.random.default_rng(2).standard_normal((1, 20, BIGVGAN_TINY["num_mels"])) * 0.5).astype(np.float32)
    params = drawn_vocoder(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(mel)), 7)
    pm = BigVGAN(BigVGANConfig(**BIGVGAN_TINY))  # use_kernel=True: the exporter rebuilds it plain
    pm.load_state_dict(weights.bigvgan_from_jax(params, pm.cfg))
    got = ex.load_exported(ex.export_vocoder(pm.eval(), b=1, t=20), device="cpu")(mel)
    want = np.asarray(japply(jm, params, mel))
    assert np.abs(want).max() < 0.99  # not clamped
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jex.load_exported(jex.export_vocoder(jm, params, b=1, t=20))(mel)),
                               atol=ATOL)
    # the v4 Generator (no kernel): the artifact equals the eager module
    vcfg = dataclasses.replace(config.vocoder_v4_config(), upsample_initial_channel=32, cfm_mel_channels=8)
    gen = Generator(vcfg, in_channels=8, use_post_bias=True, conditioned=False).eval()
    with torch.no_grad():
        eager = gen(torch.from_numpy(mel))
    assert torch.equal(ex.load_exported(ex.export_vocoder(gen, b=1, t=20), device="cpu")(mel), eager)


# ---------------------------------------------------------------------------
# the kernel wrappers refuse a traced input on the card
# ---------------------------------------------------------------------------

REFUSED = "cannot be traced"


def _k1():
    x = torch.randn(1, 512)
    kv = torch.zeros(1, 1, 16, 1024, dtype=torch.bfloat16)
    return lambda: ds.fused_decode_step(x, {}, kv, torch.ones(1, 16), 3)


def _k2():
    x = torch.randn(1, 8, 128).to(torch.bfloat16)
    return lambda: qm.qdense_int8(x, torch.zeros(128, 128, dtype=torch.int8), torch.ones(128), torch.zeros(128))


def _k3():
    x = torch.randn(1, 8, 128).to(torch.bfloat16)
    w, s, b = torch.zeros(128, 128, dtype=torch.int8), torch.ones(128), torch.zeros(128)
    return lambda: qm.qkv_rope_int8(x, w, w, w, s, s, s, b, b, b, dim_head=64)


def _k4():
    a = torch.randn(1, 2, 8, 64).to(torch.bfloat16)
    return lambda: qm.qdense_out_int8(a, torch.zeros(128, 128, dtype=torch.int8), torch.ones(128), torch.zeros(128))


def _k5():
    q = torch.randn(1, 2, 8, 64).to(torch.bfloat16)
    return lambda: qf.flash_attn_int8(q, q, q, torch.ones(1, 8), sm_scale=0.125)


def _k6():
    return lambda: sa.snake_aa(torch.randn(1, 4, 32), torch.zeros(4), torch.zeros(4))


CASES = {"K1": (_k1, ds, "_route"), "K2": (_k2, qm, "on_card"), "K3": (_k3, qm, "on_card"),
         "K4": (_k4, qm, "on_card"), "K5": (_k5, qf, "on_card"), "K6": (_k6, sa, "on_card")}


@pytest.fixture
def card_route(monkeypatch):
    """Every wrapper's device test says "card"; a launch is recorded."""
    launched = []
    for _, mod, test in CASES.values():
        monkeypatch.setattr(mod, test, lambda t: True)
        monkeypatch.setattr(mod, "_lib", lambda: launched.append(1) or (_ for _ in ()).throw(RuntimeError("launch")))
    return launched


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_wrapper_refuses_a_traced_input_on_the_card(kernel, card_route):
    with FakeTensorMode():  # what torch.export traces with
        call = CASES[kernel][0]()
        with pytest.raises(RuntimeError, match=REFUSED):
            call()
    with pytest.MonkeyPatch.context() as mp:  # what torch.compile's tracing reports
        mp.setattr(torch.compiler, "is_compiling", lambda: True)
        with pytest.raises(RuntimeError, match=REFUSED):
            CASES[kernel][0]()()
    assert not card_route
    with pytest.raises(Exception) as err:  # real tensors outside tracing go on towards the launch
        CASES[kernel][0]()()
    assert REFUSED not in str(err.value)


def test_exporting_a_kernel_model_raises_on_the_card(card_route):
    """torch.export of a BigVGAN(use_kernel=True) reaches K6's wrapper, which
    refuses; export_vocoder rebuilds it plain and exports."""
    model = BigVGAN(BigVGANConfig(**BIGVGAN_TINY)).eval()
    args = ex.vocoder_args(model, 1, 10)
    with pytest.raises(RuntimeError, match=REFUSED):
        ex.export_fn(model, args)
    assert not card_route
    blob = ex.export_vocoder(model, b=1, t=10)
    assert not card_route
    ep = torch.export.load(io.BytesIO(blob))
    assert not any("snake" in str(n.target) for n in ep.graph.nodes)


# ---------------------------------------------------------------------------
# cli export
# ---------------------------------------------------------------------------


def test_cli_export(s1, s2, v3, tmp_path, monkeypatch):
    """`export` at the JAX cli's shapes, the loaders patched to return the
    tiny models: the files of each format under the JAX package's names, a
    pt2 step that runs, and the JAX message for an ONNX v3/v4 S2."""
    from gpt_sovits_tpu_torch import cli
    from gpt_sovits_tpu_torch.utils import loaders

    voc = BigVGAN(BigVGANConfig(**BIGVGAN_TINY)).eval()
    monkeypatch.setattr(loaders, "load_s1", lambda path: s1[2])
    monkeypatch.setattr(loaders, "load_s2", lambda path, version=None: ((v3 if version == "v3" else s2)[2], version or "v2"))
    monkeypatch.setattr(loaders, "load_vocoder", lambda path, version="v3": voc)
    try:
        out = cli.main(["export", "--out-dir", str(tmp_path / "pt2"), "--s1", "s1.ckpt", "--s2", "s2.pth",
                        "--vocoder", "voc.pth", "--device", "cpu"])
        assert sorted(out) == ["s1_step", "s2_decode_v2", "vocoder"]
        for name, rec in out.items():
            assert rec["path"].endswith(f"/{name}.pt2") and (tmp_path / "pt2" / f"{name}.pt2").stat().st_size == rec["bytes"]
        step = ex.load_exported((tmp_path / "pt2" / "s1_step.pt2").read_bytes(), device="cpu")
        e, k, v, valid = s1_step_inputs(S1_TINY, 1, 2048, 5, 0)
        logits = step(e, k, v, valid, np.asarray(5, np.int32))[0]
        with torch.no_grad():
            want = s1[2].decode_step(*map(torch.from_numpy, (e, k.copy(), v.copy(), valid)), 5)
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=ATOL)

        out = cli.main(["export", "--out-dir", str(tmp_path / "onnx"), "--s1", "s1.ckpt", "--vocoder", "voc.pth",
                        "--format", "onnx", "--device", "cpu"])
        assert sorted(out) == ["s1_prefill", "s1_step", "vocoder"]
        assert all((tmp_path / "onnx" / f"{n}.onnx").is_file() for n in out)
        with pytest.raises(SystemExit, match="ONNX export covers v1/v2 graphs"):
            cli.main(["export", "--out-dir", str(tmp_path / "v3"), "--s2", "s2.pth", "--version", "v3",
                      "--format", "onnx", "--device", "cpu"])
    finally:
        import shutil

        shutil.rmtree(tmp_path, ignore_errors=True)
