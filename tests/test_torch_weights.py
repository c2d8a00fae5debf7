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
from gpt_sovits_tpu.models.vits import SynthesizerTrn as JSynth
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu.utils.checkpoint_compat import s1_params_to_torch, s2_params_to_torch
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.eres2net import ERes2NetConfig, ERes2NetV2
from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn
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


def test_encoder_converters_load_strict():
    hcfg = dict(conv_dim=16, conv_kernels=(10, 3), conv_strides=(5, 2), hidden_size=24, num_layers=2,
                num_heads=4, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=4)
    hp = _shapes(JHub(JHubCfg(**hcfg)), jnp.zeros((1, 400)))
    HubertEncoder(HubertConfig(**hcfg)).load_state_dict(weights.hubert_from_jax(hp, JHubCfg(**hcfg)), strict=True)
    scfg = dict(num_blocks=(1, 2, 1, 1), m_channels=4, feat_dim=16)
    sp = _shapes(JSV(JSVConfig(**scfg)), jnp.zeros((1, 16, 16)))
    ERes2NetV2(ERes2NetConfig(**scfg)).load_state_dict(weights.eres2net_from_jax(sp, JSVConfig(**scfg)), strict=True)
