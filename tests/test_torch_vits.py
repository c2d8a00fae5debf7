"""Port of the S2 synthesizer (gpt_sovits_tpu_torch/models/vits.py) against
the JAX SynthesizerTrn on the CPU, same weights (through s2_from_jax and the
port's weight-norm folding), numpy-made inputs, f32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.models.vits import SynthesizerTrn as JSynth
from gpt_sovits_tpu.utils.config import S2Config as JS2Config
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
from gpt_sovits_tpu_torch.utils.config import S2Config
from gpt_sovits_tpu_torch.weights import s2_from_jax

torch.set_num_threads(1)

TINY = dict(
    spec_channels=65, segment_size=8, inter_channels=32, hidden_channels=32, filter_channels=48,
    n_heads=2, n_layers=4, kernel_size=3, upsample_rates=(4, 4), upsample_initial_channel=64,
    upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
    gin_channels=32, mrte_hidden=32, ssl_dim=48, n_codes=40, sv_dim=40,
)
# versions of the slice: v2 and the v2ProPlus family (sv embedding + PReLU)
VERSIONS = {"v2": {}, "v2ProPlus": {"gin_channels": 48, "upsample_initial_channel": 96}}
B, TS, TSPEC, TT, TC = 2, 24, 30, 9, 11

# f32 on both sides; the sums run in other orders through ~40 convolutions
# and attention layers, so waveforms agree to 1e-4 absolute
ATOL = 1e-4


def random_params(model, *args, seed=0, **kw):
    """Parameters of the flax model's shapes drawn with numpy (no per-leaf
    init compiles): scales near 1, variances positive, the rest N(0, 0.2)."""
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(0),
                                                "slice": jax.random.PRNGKey(0)}, *args, **kw))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1])
        if "var" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "scale" in name or "alpha" in name:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=list(VERSIONS))
def pair(request):
    kw = dict(TINY, version=request.param, **VERSIONS[request.param])
    jcfg, pcfg = JS2Config(**kw), S2Config(**kw)
    jm = JSynth(jcfg)
    params = random_params(
        jm, jnp.zeros((1, 8, jcfg.ssl_dim)), jnp.zeros((1, 10, jcfg.spec_channels)), jnp.asarray([10]),
        jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]),
        sv_emb=jnp.zeros((1, jcfg.sv_dim)) if jcfg.is_pro else None, method=JSynth.init_all,
    )
    pm = SynthesizerTrn(pcfg)
    pm.load_state_dict(s2_from_jax(jax.tree.map(np.asarray, params), pcfg), strict=True)
    return jm, params, pm.eval(), jcfg


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        ssl=(rng.standard_normal((B, TS, cfg.ssl_dim))).astype(np.float32),
        spec=np.abs(rng.standard_normal((B, TSPEC, cfg.spec_channels))).astype(np.float32),
        spec_len=np.asarray([TSPEC, TSPEC - 7], np.int32),
        text=rng.integers(1, cfg.phoneme_vocab_size, (B, TT)).astype(np.int32),
        text_len=np.asarray([TT, TT - 3], np.int32),
        codes=rng.integers(0, cfg.n_codes, (B, TC)).astype(np.int32),
        codes_len=np.asarray([TC, TC - 4], np.int32),
        sv=(rng.standard_normal((B, cfg.sv_dim))).astype(np.float32),
    )


def _t(x):
    x = torch.from_numpy(x)
    return x.long() if x.dtype == torch.int32 else x


def test_state_dict_loads_strict_without_enc_q(pair):
    _, params, pm, jcfg = pair
    sd = s2_from_jax(jax.tree.map(np.asarray, params), jcfg)
    assert any(k.startswith("enc_q.") for k in sd)  # present in the tree ...
    missing, unexpected = pm.load_state_dict(sd, strict=True)  # ... dropped at load
    assert not missing and not unexpected


@pytest.mark.parametrize("speed", [1.0, 1.25])
def test_decode_waveform_allclose(pair, speed):
    """decode_latent + Generator == JAX decode (noise_rng=None). speed 1.25
    shrinks the encoder output, where jax.image.resize antialiases."""
    jm, params, pm, cfg = pair
    x = _inputs(cfg)
    sv = jnp.asarray(x["sv"]) if cfg.is_pro else None
    wj = jm.apply(
        params, jnp.asarray(x["codes"]), jnp.asarray(x["codes_len"]), jnp.asarray(x["text"]),
        jnp.asarray(x["text_len"]), jnp.asarray(x["spec"]), jnp.asarray(x["spec_len"]),
        speed=speed, sv_emb=sv, method=JSynth.decode,
    )
    with torch.no_grad():
        z, ge = pm.decode_latent(
            _t(x["codes"]), _t(x["codes_len"]), _t(x["text"]), _t(x["text_len"]), _t(x["spec"]),
            _t(x["spec_len"]), speed=speed, sv_emb=_t(x["sv"]) if cfg.is_pro else None,
        )
        wp = pm.dec(z, g=ge)
    assert wp.shape == wj.shape
    assert float(np.abs(np.asarray(wj)).max()) > 1e-3  # a non-trivial waveform
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=ATOL, rtol=1e-3)


def test_extract_latent_codes_equal(pair):
    jm, params, pm, cfg = pair
    x = _inputs(cfg, seed=1)
    cj = jm.apply(params, jnp.asarray(x["ssl"]), method=JSynth.extract_latent)
    with torch.no_grad():
        cp = pm.extract_latent(_t(x["ssl"]))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))


def test_compute_ge_masked_allclose(pair):
    """ge with the sv embedding (v2ProPlus) or without (v2); f32 sums in
    other orders, relative 1e-4 of ge's scale (random weights make it ~1e2)."""
    jm, params, pm, cfg = pair
    x = _inputs(cfg, seed=2)
    sv = x["sv"] if cfg.is_pro else None
    gj = jm.apply(params, jnp.asarray(x["spec"]), jnp.asarray(x["spec_len"]),
                  None if sv is None else jnp.asarray(sv), method=JSynth.compute_ge_masked)
    with torch.no_grad():
        gp = pm.compute_ge_masked(_t(x["spec"]), _t(x["spec_len"]), None if sv is None else _t(sv))
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=1e-4 * np.abs(np.asarray(gj)).max(), rtol=1e-4)
