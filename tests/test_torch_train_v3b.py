"""SynthesizerTrnV3b (models/v3.py, the hybrid GAN + CFM synthesizer)
against the JAX package's on the CPU at tiny widths: the training forward
with JAX's noise, segment starts and CFM draws, and decode_encp."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpt_sovits_tpu.models.v3 import SynthesizerTrnV3b as JV3b
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3b
from gpt_sovits_tpu_torch.utils import config as pconfig
from test_torch_train_v3 import B, TMEL, TSPEC, V3B, batch_np, forward_draws, rel, seeded_params, to_torch
from gpt_sovits_tpu_torch.train import s2_train_v3 as pt

torch.set_num_threads(1)


def v3b_setup():
    jcfg = jconfig.S2Config(**V3B)
    jm = JV3b(jcfg)
    bn = batch_np(2)
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    params = seeded_params(lambda: jm.init(keys, *(jnp.asarray(bn[k]) for k in pt.BATCH_KEYS), method=JV3b.init_all),
                           4)
    pm = SynthesizerTrnV3b(pconfig.S2Config(**V3B))
    pm.load_state_dict(weights.s2v3b_from_jax(params, jcfg), strict=True)
    return jcfg, jm, params, pm, bn


def test_v3b_forward_and_decode_encp_match_jax():
    jcfg, jm, params, pm, bn = v3b_setup()
    jb = [jnp.asarray(bn[k]) for k in pt.BATCH_KEYS]
    k_noise, k_slice, k_cfm = jax.random.split(jax.random.PRNGKey(7), 3)
    jout = jax.jit(lambda p: jm.apply(p, *jb, rngs_noise=k_noise, rng_slice=k_slice, rng_cfm=k_cfm))(params)
    noise = np.array(jax.random.normal(k_noise, (B, TSPEC, V3B["inter_channels"])))
    t = min(TMEL, int(TSPEC * 1.875))
    tb = to_torch(bn)
    with torch.no_grad():
        out = pm(*(tb[k] for k in pt.BATCH_KEYS), noise=noise, ids_slice=np.asarray(jout["ids_slice"]),
                 draws=forward_draws(k_cfm, B, t, V3B["cfm_mel_channels"]))
    assert set(out) == set(jout)
    np.testing.assert_array_equal(out["ids_slice"].numpy(), np.asarray(jout["ids_slice"]))
    for k in ("wav_hat", "y_mask", "z", "z_p", "m_p", "logs_p", "m_q", "logs_q", "commit_loss", "cfm_loss",
              "mel_mse"):
        assert rel(out[k].numpy(), np.asarray(jout[k])) < 1e-5, (k, rel(out[k].numpy(), np.asarray(jout[k])))

    rng = np.random.default_rng(8)
    codes = rng.integers(0, V3B["n_codes"], (1, 14))
    text = rng.integers(1, 700, (1, 9))
    spec = np.abs(rng.standard_normal((1, 30, V3B["spec_channels"]))).astype(np.float32)
    fj, gj, mj = jm.apply(params, jnp.asarray(codes, jnp.int32), jnp.asarray([13]), jnp.asarray(text, jnp.int32),
                          jnp.asarray([9]), jnp.asarray(spec), jnp.asarray([27]), method=JV3b.decode_encp)
    with torch.no_grad():
        fp, gp, mp = pm.decode_encp(torch.from_numpy(codes), torch.tensor([13]), torch.from_numpy(text),
                                    torch.tensor([9]), torch.from_numpy(spec), torch.tensor([27]))
    assert int(mp[0]) == int(mj[0]) == int(13 * 3.75)
    assert rel(gp.numpy(), np.asarray(gj)) < 1e-5 and rel(fp.numpy(), np.asarray(fj)) < 1e-5
