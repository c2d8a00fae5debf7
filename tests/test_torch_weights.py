"""The port's weight converters (gpt_sovits_tpu_torch/weights.py) emit,
tensor for tensor, what the JAX package's reference exporters emit, and
every port module loads its converted state dict with strict=True."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.models.eres2net import ERes2NetConfig as JSVConfig
from gpt_sovits_tpu.models.eres2net import ERes2NetV2 as JSV
from gpt_sovits_tpu.models.hubert import HubertConfig as JHubCfg
from gpt_sovits_tpu.models.hubert import HubertEncoder as JHub
from gpt_sovits_tpu.models.t2s import T2SDecoder as JT2S
from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3 as JV3
from gpt_sovits_tpu.models.vits import Generator as JGen
from gpt_sovits_tpu.models.vits import SynthesizerTrn as JSynth
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu.utils.checkpoint_compat import s1_params_to_torch, s2_params_to_torch, s2v3_params_to_torch
from gpt_sovits_tpu.utils.loaders import load_vocoder
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.eres2net import ERes2NetConfig, ERes2NetV2
from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
from gpt_sovits_tpu_torch.models.vits import Generator, SynthesizerTrn
from gpt_sovits_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

S1 = dict(vocab_size=41, phoneme_vocab_size=37, embedding_dim=32, hidden_dim=32, num_heads=4, ffn_dim=64,
          num_layers=2, eos_id=40, bert_dim=16, max_len=64)
S2 = dict(spec_channels=65, segment_size=8, inter_channels=16, hidden_channels=16, filter_channels=24,
          n_heads=2, n_layers=2, kernel_size=3, upsample_rates=(4, 2), upsample_initial_channel=32,
          upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
          gin_channels=16, mrte_hidden=16, ssl_dim=16, n_codes=12, sv_dim=24)


def _shapes(model, *args, **kw):
    """A parameter tree of the model's shapes with numpy values (seeded)."""
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(0), "slice": jax.random.PRNGKey(0)}
    shapes = jax.eval_shape(lambda: model.init(keys, *args, **kw))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _assert_same(ours, theirs):
    assert set(ours) == set(theirs), set(ours) ^ set(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k
        torch.testing.assert_close(ours[k], v, rtol=0, atol=0, msg=k)


def test_s1_from_jax_equals_reference_exporter():
    cfg = jconfig.S1Config(**S1)
    params = _shapes(JT2S(cfg), method=JT2S.init_all)
    sd = weights.s1_from_jax(params, cfg)
    _assert_same(sd, s1_params_to_torch(params, cfg))
    T2SDecoder(pconfig.S1Config(**S1)).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("version", ["v2", "v2Pro", "v2ProPlus"])
def test_s2_from_jax_equals_reference_exporter(version):
    kw = dict(S2, version=version)
    cfg = jconfig.S2Config(**kw)
    params = _shapes(
        JSynth(cfg), jnp.zeros((1, 8, cfg.ssl_dim)), jnp.zeros((1, 10, cfg.spec_channels)), jnp.asarray([10]),
        jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]),
        sv_emb=jnp.zeros((1, cfg.sv_dim)) if cfg.is_pro else None, method=JSynth.init_all,
    )
    sd = weights.s2_from_jax(params, cfg)
    _assert_same(sd, s2_params_to_torch(params, cfg))
    model = SynthesizerTrn(pconfig.S2Config(**kw))
    missing, unexpected = model.load_state_dict(sd, strict=True)  # enc_q.* dropped, weight norm folded
    assert not missing and not unexpected
    # a folded weight equals the JAX kernel it came from (to f32 rounding)
    w = np.asarray(params["params"]["dec"]["resblock_0_0"]["c1_0"]["Conv_0"]["kernel"]).transpose(2, 1, 0)
    np.testing.assert_allclose(model.dec.resblocks[0].convs1[0].weight.detach().numpy(), w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("version", ["v2", "v2ProPlus"])
def test_s2_from_jax_keeps_enc_q_for_a_training_model(version):
    """s2_from_jax carries the posterior encoder as the JAX exporter writes it;
    a model built for training (posterior=True) loads it strictly, and an
    inference model drops it."""
    kw = dict(S2, version=version)
    cfg = jconfig.S2Config(**kw)
    params = _shapes(
        JSynth(cfg), jnp.zeros((1, 8, cfg.ssl_dim)), jnp.zeros((1, 10, cfg.spec_channels)), jnp.asarray([10]),
        jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]),
        sv_emb=jnp.zeros((1, cfg.sv_dim)) if cfg.is_pro else None, method=JSynth.init_all,
    )
    w = np.asarray(params["params"]["enc_q"]["enc"]["in_3"]["Conv_0"]["kernel"]).transpose(2, 1, 0)
    sd = weights.s2_from_jax(params, cfg)
    assert any(k.startswith("enc_q.") for k in sd) and "enc_q.enc.in_layers.3.weight_g" in sd
    _assert_same({k: v for k, v in sd.items() if k.startswith("enc_q.")},
                 {k: v for k, v in s2_params_to_torch(params, cfg).items() if k.startswith("enc_q.")})
    model = SynthesizerTrn(pconfig.S2Config(**kw), posterior=True)
    missing, unexpected = model.load_state_dict(sd, strict=True)  # weight norm folded, enc_q kept
    assert not missing and not unexpected
    np.testing.assert_allclose(model.enc_q.enc.in_layers[3].weight.detach().numpy(), w, rtol=1e-6, atol=1e-6)
    inference = SynthesizerTrn(pconfig.S2Config(**kw))
    inference.load_state_dict(sd, strict=True)
    assert not hasattr(inference, "enc_q")


@pytest.mark.parametrize("periods", [(2, 3, 5, 7, 11), (2, 3, 5, 7, 11, 17, 23)])
def test_d_from_jax_is_read_back_by_the_jax_reader(periods):
    """d_from_jax writes the reference names that the JAX package's
    d_params_from_torch reads: read back there, every kernel comes back
    unchanged; the port's discriminator loads it strictly, and folds a
    DDP-prefixed, weight-normed copy to the same weights."""
    from gpt_sovits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
    from gpt_sovits_tpu.utils.checkpoint_compat import d_params_from_torch
    from gpt_sovits_tpu_torch.models.discriminators import MultiPeriodDiscriminator

    x = jnp.zeros((1, 64, 1))
    params = _shapes(JMPD(periods), x, x)
    sd = weights.d_from_jax(params, periods)
    back = d_params_from_torch(sd, periods)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), back, params)
    model = MultiPeriodDiscriminator(periods)
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    wn = {}
    for k, v in sd.items():
        if k.endswith(".weight"):
            g = torch.sqrt((v**2).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
            wn[f"module.{k[:-len('weight')]}weight_g"], wn[f"module.{k[:-len('weight')]}weight_v"] = g, v
        else:
            wn[f"module.{k}"] = v
    again = MultiPeriodDiscriminator(periods)
    again.load_state_dict(wn, strict=True)
    for (name, a), b in zip(again.state_dict().items(), model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=name)


def test_encoder_converters_load_strict():
    hcfg = dict(conv_dim=16, conv_kernels=(10, 3), conv_strides=(5, 2), hidden_size=24, num_layers=2,
                num_heads=4, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=4)
    hp = _shapes(JHub(JHubCfg(**hcfg)), jnp.zeros((1, 400)))
    HubertEncoder(HubertConfig(**hcfg)).load_state_dict(weights.hubert_from_jax(hp, JHubCfg(**hcfg)), strict=True)
    scfg = dict(num_blocks=(1, 2, 1, 1), m_channels=4, feat_dim=16)
    sp = _shapes(JSV(JSVConfig(**scfg)), jnp.zeros((1, 16, 16)))
    ERes2NetV2(ERes2NetConfig(**scfg)).load_state_dict(weights.eres2net_from_jax(sp, JSVConfig(**scfg)), strict=True)


V4 = dict(S2, version="v4", cfm_mel_channels=20, cfm_dit_depth=2, cfm_dit_dim=64, cfm_dit_heads=4)


def test_s2v3_from_jax_equals_reference_exporter():
    cfg = jconfig.S2Config(**V4)
    params = _shapes(
        JV3(cfg), jnp.zeros((1, 16, cfg.ssl_dim)), jnp.zeros((1, 16, cfg.spec_channels)), jnp.asarray([16]),
        jnp.zeros((1, 30, 20)), jnp.asarray([30]), jnp.zeros((1, 5), jnp.int32), jnp.asarray([5]),
        method=JV3.init_all,
    )
    sd = weights.s2v3_from_jax(params, cfg)
    _assert_same(sd, s2v3_params_to_torch(params, cfg))
    model = SynthesizerTrnV3(pconfig.S2Config(**V4))
    missing, unexpected = model.load_state_dict(sd, strict=True)  # wns1's weight norm folded
    assert not missing and not unexpected
    w = np.asarray(params["params"]["cfm"]["estimator"]["block_1"]["ff2"]["kernel"]).T
    np.testing.assert_array_equal(model.cfm.estimator.transformer_blocks[1].ff.ff[2].weight.detach().numpy(), w)


def test_vocoder_v4_names_read_by_the_jax_loader(tmp_path):
    """vocoder_v4_from_jax writes what the JAX package's v4 vocoder loader
    reads (utils/loaders.py:170-184): saved and read back there, every
    parameter comes back unchanged; the port's Generator loads it strictly."""
    import torch as _torch

    full = pconfig.vocoder_v4_config()
    jfull = jconfig.replace(jconfig.s2_config_for_version("v4"), upsample_rates=(10, 6, 2, 2, 2),
                            upsample_kernel_sizes=(20, 12, 4, 4, 4), upsample_initial_channel=512)
    assert (full.upsample_rates, full.upsample_kernel_sizes, full.upsample_initial_channel) == (
        jfull.upsample_rates, jfull.upsample_kernel_sizes, jfull.upsample_initial_channel)
    params = _shapes(JGen(jfull, use_post_bias=True), jnp.zeros((1, 4, 100)))
    sd = weights.vocoder_v4_from_jax(params, full)
    assert not any(k.startswith("cond") for k in sd)
    path = tmp_path / "vocoder.pth"
    _torch.save(sd, path)
    _, back = load_vocoder(str(path), "v4")
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back_flat)
    for p, v in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[p]), v, err_msg=str(p))
    Generator(full, in_channels=100, use_post_bias=True, conditioned=False).load_state_dict(sd, strict=True)


V3B = dict(S2, version="v3", cfm_mel_channels=12, cfm_dit_depth=2, cfm_dit_dim=32, cfm_dit_heads=2)


def test_s2v3b_from_jax_equals_the_reference_exporters():
    """SynthesizerTrnV3b: the v3 tensors as s2v3_params_to_torch emits them,
    the VITS stack's (dec, flow, enc_q) as s2_params_to_torch does, and
    linear_mel; the port's module loads them strictly."""
    from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3b as JV3b
    from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3b

    cfg = jconfig.S2Config(**V3B)
    z = jnp.zeros
    params = _shapes(JV3b(cfg), z((1, 16, cfg.ssl_dim)), z((1, 16, cfg.spec_channels)), jnp.asarray([16]),
                     z((1, 30, 12)), jnp.asarray([30]), z((1, 5), jnp.int32), jnp.asarray([5]), method=JV3b.init_all)
    sd = weights.s2v3b_from_jax(params, cfg)
    want = {**s2_params_to_torch(params, cfg), **s2v3_params_to_torch(params, cfg)}
    want["linear_mel.weight"] = torch.from_numpy(np.asarray(params["params"]["linear_mel"]["Conv_0"]["kernel"]).T.copy())
    want["linear_mel.bias"] = torch.from_numpy(np.asarray(params["params"]["linear_mel"]["Conv_0"]["bias"]))
    _assert_same(sd, want)
    missing, unexpected = SynthesizerTrnV3b(pconfig.S2Config(**V3B)).load_state_dict(sd, strict=True)
    assert not missing and not unexpected


def test_lora_from_jax_delta_is_the_transpose():
    """JAX adds a @ b to a flax kernel (in, out); the torch weight is its
    transpose, so the port's B @ A must equal (a @ b).T. Held on merged
    weights, which a transposed delta would change even where W is square."""
    from gpt_sovits_tpu.train.s2_train_v3 import init_lora, merge_lora
    from gpt_sovits_tpu_torch.train.s2_train_v3 import lora_targets
    from gpt_sovits_tpu_torch.train.s2_train_v3 import merge_lora as p_merge

    cfg = jconfig.S2Config(**dict(V3B, version="v4"))
    z = jnp.zeros
    params = _shapes(JV3(cfg), z((1, 16, cfg.ssl_dim)), z((1, 16, cfg.spec_channels)), jnp.asarray([16]),
                     z((1, 30, 12)), jnp.asarray([30]), z((1, 5), jnp.int32), jnp.asarray([5]), method=JV3.init_all)
    lora = jax.tree.map(np.asarray, init_lora(params, 3, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    lora = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), lora)  # b != 0
    plora = weights.lora_from_jax(lora)
    model = SynthesizerTrnV3(pconfig.S2Config(**dict(V3B, version="v4")))
    model.load_state_dict(weights.s2v3_from_jax(params, cfg), strict=True)
    assert sorted(plora) == sorted(lora_targets(model)) and len(plora) == 8
    for f in plora.values():
        assert f["A"].shape[0] == 3 and f["B"].shape[1] == 3
    merged = p_merge(model.state_dict(), plora)
    want = weights.s2v3_from_jax(jax.tree.map(np.asarray, merge_lora(params, lora)), cfg)
    for name in plora:
        torch.testing.assert_close(merged[name], want[name], rtol=1e-5, atol=1e-5, msg=name)


def test_bigvgan_d_from_jax_names_load_strictly():
    from gpt_sovits_tpu.train.bigvgan_train import BigVGANDiscriminators as JD
    from gpt_sovits_tpu_torch.train.bigvgan_train import BigVGANDiscriminators

    periods, res = (2, 3), ((128, 32, 64),)
    y = jnp.zeros((1, 512, 1))
    params = _shapes(JD(periods=periods, resolutions=res), y, y)
    sd = weights.bigvgan_d_from_jax(params, periods, res)
    mpd = weights.d_from_jax({"params": params["params"]["mpd"]}, periods)
    mrd = weights.mrd_from_jax({"params": params["params"]["mrd"]}, res)
    assert sd.keys() == {f"mpd.{k}" for k in mpd} | {f"mrd.{k}" for k in mrd}
    BigVGANDiscriminators(periods, res).load_state_dict(sd, strict=True)
