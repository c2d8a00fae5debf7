"""The port's BertEncoder (chinese-roberta's architecture at hidden 1024, 16
heads, few layers) against the flax module of the JAX package, with the
weights carried over by `bert_from_jax`; its state dict against HF
`BertModel`'s names; `phone_level_features`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_sovits_tpu.models.bert import BertConfig as JBertConfig
from gpt_sovits_tpu.models.bert import BertEncoder as JBert
from gpt_sovits_tpu.models.bert import phone_level_features as j_plf
from gpt_sovits_tpu_torch.models.bert import BertConfig, BertEncoder, phone_level_features
from gpt_sovits_tpu_torch.weights import bert_from_jax

CFG = dict(vocab_size=300, hidden_size=1024, num_layers=3, num_heads=16, intermediate_size=1024,
           max_position_embeddings=64)


def bert_params(cfg: JBertConfig, seed: int = 0):
    """flax parameters of the JAX BertEncoder drawn with numpy: LayerNorm
    scales near 1, everything else N(0, 0.05)."""
    shapes = jax.eval_shape(lambda: JBert(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if str(path[-1]) == "['scale']":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_bert(params, cfg: BertConfig) -> BertEncoder:
    model = BertEncoder(cfg)
    model.load_state_dict(bert_from_jax(jax.tree.map(np.asarray, params), cfg), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def berts():
    jcfg = JBertConfig(**CFG)
    params = bert_params(jcfg)
    return JBert(jcfg), params, port_bert(params, BertConfig(**CFG))


def test_hidden_states_match_flax(berts):
    """Every hidden state (embeddings first) on two rows, the second padded
    after 7 tokens, at tests/test_bert.py's bar."""
    jm, params, pm = berts
    rng = np.random.default_rng(1)
    ids = rng.integers(0, CFG["vocab_size"], (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, 7:] = False
    want = jm.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    assert len(got) == len(want) == CFG["num_layers"] + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=1e-3)


def test_state_dict_names_load_hf_bertmodel():
    """HF BertModel's state dict without the pooler loads with strict=True,
    and the port then gives HF's hidden states."""
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.BertConfig(
        vocab_size=CFG["vocab_size"], hidden_size=1024, num_hidden_layers=2, num_attention_heads=16,
        intermediate_size=CFG["intermediate_size"], max_position_embeddings=CFG["max_position_embeddings"],
        type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu", attn_implementation="eager",
    )
    torch.manual_seed(0)
    hf = transformers.BertModel(hcfg).eval()
    sd = {k: v for k, v in hf.state_dict().items() if not k.startswith("pooler.")}
    pm = BertEncoder(BertConfig(**{**CFG, "num_layers": 2}))
    pm.load_state_dict(sd, strict=True)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, CFG["vocab_size"], (1, 9)))
    with torch.no_grad():
        want = hf(ids, output_hidden_states=True).hidden_states
        got = pm.eval()(ids)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_phone_level_features_match():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((5, 8)).astype(np.float32)
    word2ph = [2, 1, 3, 2, 1]
    got = phone_level_features(torch.from_numpy(h), word2ph)
    want = np.asarray(j_plf(jnp.asarray(h), word2ph))
    assert got.shape == (9, 8)
    np.testing.assert_array_equal(got.numpy(), want)

