"""Parameter trees of the JAX package -> state dicts of the port.

Each function takes a JAX parameter tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns a state dict under the
reference project's names, which the port's module loads with strict=True.
For S1 and S2 these are exactly the names (and, for S2, the weight-norm
``weight_g``/``weight_v`` pairs) of the reference checkpoints; the port's
SynthesizerTrn folds the pairs when it loads them.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv_node(node):
    return node["Conv_0"] if "Conv_0" in node else node


def _conv(node, prefix, out, *, weight_norm=False):
    """flax Conv {kernel (k,in,out)} -> torch Conv1d weight (out,in,k)."""
    k = _conv_node(node)
    w = np.asarray(k["kernel"], np.float32).transpose(2, 1, 0)
    if weight_norm:
        # g * v / ||v|| == w exactly for v = w, g = ||w|| over dims != 0
        g = np.sqrt((w**2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
        out[f"{prefix}.weight_g"] = _t(g)
        out[f"{prefix}.weight_v"] = _t(w)
    else:
        out[f"{prefix}.weight"] = _t(w)
    if "bias" in k:
        out[f"{prefix}.bias"] = _t(k["bias"])


def _dense(node, prefix, out):
    out[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
    if "bias" in node:
        out[f"{prefix}.bias"] = _t(node["bias"])


def _dense_as_conv1x1(node, prefix, out):
    out[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T[:, :, None])
    if "bias" in node:
        out[f"{prefix}.bias"] = _t(node["bias"])


def _ln(node, prefix, out, gamma="weight", beta="bias"):
    out[f"{prefix}.{gamma}"] = _t(node["scale"])
    out[f"{prefix}.{beta}"] = _t(node["bias"])


# ---------------------------------------------------------------------------
# S1
# ---------------------------------------------------------------------------


def s1_from_jax(params: dict, cfg) -> dict:
    p = params["params"]
    out = {
        "ar_text_embedding.word_embeddings.weight": _t(p["text_embedding"]["embedding"]),
        "ar_audio_embedding.word_embeddings.weight": _t(p["audio_embedding"]["embedding"]),
        "ar_text_position.alpha": _t(np.asarray(p["alpha_text"]).reshape(())),
        "ar_audio_position.alpha": _t(np.asarray(p["alpha_audio"]).reshape(())),
        "ar_predict_layer.weight": _t(np.asarray(p["predict"]["kernel"]).T),
    }
    _dense(p["bert_proj"], "bert_proj", out)
    for i in range(cfg.num_layers):
        lp, pre = p[f"layer_{i}"], f"h.layers.{i}"
        out[f"{pre}.self_attn.in_proj_weight"] = _t(np.asarray(lp["wqkv"]["kernel"]).T)
        out[f"{pre}.self_attn.in_proj_bias"] = _t(lp["wqkv"]["bias"])
        _dense(lp["wo"], f"{pre}.self_attn.out_proj", out)
        _dense(lp["fc1"], f"{pre}.linear1", out)
        _dense(lp["fc2"], f"{pre}.linear2", out)
        _ln(lp["norm1"], f"{pre}.norm1", out)
        _ln(lp["norm2"], f"{pre}.norm2", out)
    return out


# ---------------------------------------------------------------------------
# S2
# ---------------------------------------------------------------------------


def _relpos_encoder(node, pre, n_layers, out):
    for i in range(n_layers):
        a = node[f"attn_{i}"]
        for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _dense_as_conv1x1(a[nm], f"{pre}.attn_layers.{i}.{nm}", out)
        out[f"{pre}.attn_layers.{i}.emb_rel_k"] = _t(a["emb_rel_k"])
        out[f"{pre}.attn_layers.{i}.emb_rel_v"] = _t(a["emb_rel_v"])
        _ln(node[f"norm1_{i}"], f"{pre}.norm_layers_1.{i}", out, "gamma", "beta")
        _ln(node[f"norm2_{i}"], f"{pre}.norm_layers_2.{i}", out, "gamma", "beta")
        _conv(node[f"ffn_{i}"]["conv1"], f"{pre}.ffn_layers.{i}.conv_1", out)
        _conv(node[f"ffn_{i}"]["conv2"], f"{pre}.ffn_layers.{i}.conv_2", out)


def _wn(node, pre, n_layers, out):
    if "cond_layer" in node:
        _conv(node["cond_layer"], f"{pre}.cond_layer", out, weight_norm=True)
    for i in range(n_layers):
        _conv(node[f"in_{i}"], f"{pre}.in_layers.{i}", out, weight_norm=True)
        _conv(node[f"res_skip_{i}"], f"{pre}.res_skip_layers.{i}", out, weight_norm=True)


def _enc_p(e, n_layers, out):
    _conv(e["ssl_proj"], "enc_p.ssl_proj", out)
    _relpos_encoder(e["encoder_ssl"], "enc_p.encoder_ssl", n_layers // 2, out)
    out["enc_p.text_embedding.weight"] = _t(e["text_embedding"]["embedding"])
    _relpos_encoder(e["encoder_text"], "enc_p.encoder_text", n_layers, out)
    m = e["mrte"]
    for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
        _dense_as_conv1x1(m["cross_attention"][nm], f"enc_p.mrte.cross_attention.{nm}", out)
    _conv(m["c_pre"], "enc_p.mrte.c_pre", out)
    _conv(m["text_pre"], "enc_p.mrte.text_pre", out)
    _conv(m["c_post"], "enc_p.mrte.c_post", out)
    _relpos_encoder(e["encoder2"], "enc_p.encoder2", n_layers // 2, out)
    _conv(e["proj"], "enc_p.proj", out)


def _style_encoder(r, out):
    _dense(r["spectral1"], "ref_enc.spectral.0.fc", out)
    _dense(r["spectral2"], "ref_enc.spectral.3.fc", out)
    _conv(r["temporal1"]["conv1"], "ref_enc.temporal.0.conv1.conv", out)
    _conv(r["temporal2"]["conv1"], "ref_enc.temporal.1.conv1.conv", out)
    for nm in ("w_qs", "w_ks", "w_vs", "fc"):
        _dense(r["slf_attn"][nm], f"ref_enc.slf_attn.{nm}", out)
    _dense(r["fc"], "ref_enc.fc.fc", out)


def _generator(dec, pre, cfg, out, *, weight_norm: bool):
    """The HiFiGAN generator's convolutions under `pre` (`dec.` in S2, none
    in the standalone v4 vocoder)."""
    _conv(dec["conv_pre"], f"{pre}conv_pre", out)
    if "cond" in dec:
        _conv(dec["cond"], f"{pre}cond", out)
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        w = np.asarray(dec[f"up_{i}"]["kernel"], np.float32).transpose(1, 2, 0)  # (k,in,out)->(in,out,k)
        if weight_norm:
            out[f"{pre}ups.{i}.weight_g"] = _t(np.sqrt((w**2).sum(axis=(1, 2), keepdims=True)))
            out[f"{pre}ups.{i}.weight_v"] = _t(w)
        else:
            out[f"{pre}ups.{i}.weight"] = _t(w)
        if "bias" in dec[f"up_{i}"]:
            out[f"{pre}ups.{i}.bias"] = _t(dec[f"up_{i}"]["bias"])
        for j in range(n_k):
            rb = dec[f"resblock_{i}_{j}"]
            for d in range(len(cfg.resblock_dilation_sizes[j])):
                _conv(rb[f"c1_{d}"], f"{pre}resblocks.{i * n_k + j}.convs1.{d}", out, weight_norm=weight_norm)
                _conv(rb[f"c2_{d}"], f"{pre}resblocks.{i * n_k + j}.convs2.{d}", out, weight_norm=weight_norm)
    _conv(dec["conv_post"], f"{pre}conv_post", out)


def s2_from_jax(params: dict, cfg) -> dict:
    """SynthesizerTrn (v1/v2/v2Pro/v2ProPlus) under the reference names."""
    p = params["params"]
    out: dict = {}
    _enc_p(p["enc_p"], cfg.n_layers, out)
    _generator(p["dec"], "dec.", cfg, out, weight_norm=True)

    for i in range(4):
        fl = p["flow"][f"flow_{i}"]
        _conv(fl["pre"], f"flow.flows.{i * 2}.pre", out)
        _wn(fl["enc"], f"flow.flows.{i * 2}.enc", 4, out)
        _conv(fl["post"], f"flow.flows.{i * 2}.post", out)

    _style_encoder(p["ref_enc"], out)
    _conv(p["ssl_proj"], "ssl_proj", out)
    out["quantizer.vq.layers.0._codebook.embed"] = _t(p["quantizer"]["embed"])
    if "enc_q" in p:
        _conv(p["enc_q"]["pre"], "enc_q.pre", out)
        _wn(p["enc_q"]["enc"], "enc_q.enc", 16, out)
        _conv(p["enc_q"]["proj"], "enc_q.proj", out)
    if cfg.is_pro:
        _dense(p["sv_emb"], "sv_emb", out)
        _dense(p["ge_to512"], "ge_to512", out)
        out["prelu.weight"] = _t(p["prelu_alpha"])
    return out


# ---------------------------------------------------------------------------
# v3/v4: SynthesizerTrnV3 with its DiT, and the v4 vocoder
# ---------------------------------------------------------------------------


def _dit(node, pre, depth, conv_layers, out):
    """models/dit.py parameters -> the reference f5_tts DiT names, each
    prefixed with `pre`."""
    for which in ("time_embed", "d_embed"):
        _dense(node[which]["mlp1"], f"{pre}{which}.time_mlp.0", out)
        _dense(node[which]["mlp2"], f"{pre}{which}.time_mlp.2", out)
    for i in range(conv_layers):
        tb = node["text_embed"][f"block_{i}"]
        tp = f"{pre}text_embed.text_blocks.{i}"
        _conv(tb["dwconv"], f"{tp}.dwconv", out)
        _ln(tb["norm"], f"{tp}.norm", out)
        _dense(tb["pwconv1"], f"{tp}.pwconv1", out)
        _dense(tb["pwconv2"], f"{tp}.pwconv2", out)
        out[f"{tp}.grn.gamma"] = _t(tb["grn"]["gamma"])
        out[f"{tp}.grn.beta"] = _t(tb["grn"]["beta"])
    ie = node["input_embed"]
    _dense(ie["proj"], f"{pre}input_embed.proj", out)
    _conv(ie["conv_pos_embed"]["conv1"], f"{pre}input_embed.conv_pos_embed.conv1d.0", out)
    _conv(ie["conv_pos_embed"]["conv2"], f"{pre}input_embed.conv_pos_embed.conv1d.2", out)
    _dense(node["norm_out_linear"], f"{pre}norm_out.linear", out)
    _dense(node["proj_out"], f"{pre}proj_out", out)
    for i in range(depth):
        b = node[f"block_{i}"]
        bp = f"{pre}transformer_blocks.{i}"
        _dense(b["ada_linear"], f"{bp}.attn_norm.linear", out)
        for nm in ("to_q", "to_k", "to_v"):
            _dense(b[nm], f"{bp}.attn.{nm}", out)
        _dense(b["to_out"], f"{bp}.attn.to_out.0", out)
        _dense(b["ff1"], f"{bp}.ff.ff.0.0", out)
        _dense(b["ff2"], f"{bp}.ff.ff.2", out)


def dit_from_jax(params: dict, cfg) -> dict:
    """A models/dit.py DiT alone (cfg: its DiTConfig) under the reference
    names, without the `cfm.estimator.` prefix."""
    out: dict = {}
    _dit(params["params"], "", cfg.depth, cfg.conv_layers, out)
    return out


def s2v3_from_jax(params: dict, cfg) -> dict:
    """SynthesizerTrnV3 (v3/v4) under the reference names (those of
    checkpoint_compat.py `s2v3_params_to_torch`), weight-norm pairs in wns1."""
    p = params["params"]
    out: dict = {}
    _enc_p(p["enc_p"], cfg.n_layers, out)
    _style_encoder(p["ref_enc"], out)
    _conv(p["ssl_proj"], "ssl_proj", out)
    out["quantizer.vq.layers.0._codebook.embed"] = _t(p["quantizer"]["embed"])
    _conv(p["bridge"], "bridge.0", out)
    _conv(p["wns1"]["pre"], "wns1.pre", out)
    _wn(p["wns1"]["enc"], "wns1.enc", 8, out)
    _conv(p["wns1"]["proj"], "wns1.proj", out)
    _dit(p["cfm"]["estimator"], "cfm.estimator.", cfg.cfm_dit_depth, 4, out)
    return out


def vocoder_v4_from_jax(params: dict, cfg) -> dict:
    """The v4 vocoder (models/vits.py Generator, no cond) under the names
    the reference's vocoder checkpoint uses (loaders.py:170-184), weights
    plain (weight norm already removed)."""
    out: dict = {}
    _generator(params["params"], "", cfg, out, weight_norm=False)
    return out


# ---------------------------------------------------------------------------
# v3: the BigVGAN vocoder and AP-BWE
# ---------------------------------------------------------------------------


def bigvgan_from_jax(params: dict, cfg) -> dict:
    """models/bigvgan.py BigVGAN (cfg: its BigVGANConfig) under the names
    that models/bigvgan.py:202 `params_from_torch` reads (the reference
    checkpoint's), weights plain."""
    p = params["params"]
    out: dict = {}
    _conv(p["conv_pre"], "conv_pre", out)
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        up = p[f"up_{i}"]
        out[f"ups.{i}.0.weight"] = _t(np.asarray(up["kernel"]).transpose(1, 2, 0))  # (k,in,out)->(in,out,k)
        out[f"ups.{i}.0.bias"] = _t(up["bias"])
        for j in range(n_k):
            rb, pre = p[f"resblock_{i}_{j}"], f"resblocks.{i * n_k + j}"
            for d in range(len(cfg.resblock_dilation_sizes[j])):
                _conv(rb[f"c1_{d}"], f"{pre}.convs1.{d}", out)
                _conv(rb[f"c2_{d}"], f"{pre}.convs2.{d}", out)
                for a, act in ((2 * d, "act1"), (2 * d + 1, "act2")):  # stored interleaved
                    out[f"{pre}.activations.{a}.act.alpha"] = _t(rb[f"{act}_{d}"]["alpha"])
                    out[f"{pre}.activations.{a}.act.beta"] = _t(rb[f"{act}_{d}"]["beta"])
    out["activation_post.act.alpha"] = _t(p["activation_post"]["alpha"])
    out["activation_post.act.beta"] = _t(p["activation_post"]["beta"])
    _conv(p["conv_post"], "conv_post", out)
    return out


def apbwe_from_jax(params: dict, cfg) -> dict:
    """models/apbwe.py APNetBWE (cfg: its APBWEConfig) under the names that
    models/apbwe.py:134 `params_from_torch` reads (the reference's)."""
    p = params["params"]
    out: dict = {}
    for s in ("mag", "pha"):
        _conv(p[f"conv_pre_{s}"], f"conv_pre_{s}", out)
        _ln(p[f"norm_pre_{s}"], f"norm_pre_{s}", out)
        for i in range(cfg.layers):
            blk, pre = p[f"convnext_{s}_{i}"], f"convnext_{s}.{i}"
            _conv(blk["dwconv"], f"{pre}.dwconv", out)
            _ln(blk["norm"], f"{pre}.norm", out)
            _dense(blk["pwconv1"], f"{pre}.pwconv1", out)
            _dense(blk["pwconv2"], f"{pre}.pwconv2", out)
            out[f"{pre}.gamma"] = _t(np.asarray(blk["gamma"]).reshape(-1))
        _ln(p[f"norm_post_{s}"], f"norm_post_{s}", out)
    for nm in ("linear_post_mag", "linear_post_pha_r", "linear_post_pha_i"):
        _dense(p[nm], nm, out)
    return out


# ---------------------------------------------------------------------------
# CNHuBERT (HF HubertModel names)
# ---------------------------------------------------------------------------


def hubert_from_jax(params: dict, cfg) -> dict:
    p = params["params"]
    out: dict = {}
    fe = p["feature_extractor"]
    for i in range(len(cfg.conv_kernels)):
        out[f"feature_extractor.conv_layers.{i}.conv.weight"] = _t(np.asarray(fe[f"conv_{i}"]["kernel"]).transpose(2, 1, 0))
    _ln(fe["group_norm"], "feature_extractor.conv_layers.0.layer_norm", out)
    _ln(p["fp_layer_norm"], "feature_projection.layer_norm", out)
    _dense(p["fp_projection"], "feature_projection.projection", out)
    out["encoder.pos_conv_embed.conv.weight"] = _t(np.asarray(p["pos_conv"]["kernel"]).transpose(2, 1, 0))
    out["encoder.pos_conv_embed.conv.bias"] = _t(p["pos_conv"]["bias"])
    _ln(p["encoder_layer_norm"], "encoder.layer_norm", out)
    for i in range(cfg.num_layers):
        lp, pre = p[f"layer_{i}"], f"encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(lp[nm], f"{pre}.attention.{nm}", out)
        _ln(lp["layer_norm"], f"{pre}.layer_norm", out)
        _dense(lp["fc1"], f"{pre}.feed_forward.intermediate_dense", out)
        _dense(lp["fc2"], f"{pre}.feed_forward.output_dense", out)
        _ln(lp["final_layer_norm"], f"{pre}.final_layer_norm", out)
    return out


# ---------------------------------------------------------------------------
# ERes2NetV2 (reference eres2net names, BatchNorm running stats)
# ---------------------------------------------------------------------------


def _conv2d(node, prefix, out):
    out[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))  # (kh,kw,in,out)->(out,in,kh,kw)
    if "bias" in node:
        out[f"{prefix}.bias"] = _t(node["bias"])


def _bn(node, prefix, out):
    out[f"{prefix}.weight"] = _t(node["scale"])
    out[f"{prefix}.bias"] = _t(node["bias"])
    out[f"{prefix}.running_mean"] = _t(node["mean"])
    out[f"{prefix}.running_var"] = _t(node["var"])


def _aff(node, prefix, out):
    _conv2d(node["conv1"], f"{prefix}.local_att.0", out)
    _bn(node["bn1"], f"{prefix}.local_att.1", out)
    _conv2d(node["conv2"], f"{prefix}.local_att.3", out)
    _bn(node["bn2"], f"{prefix}.local_att.4", out)


def eres2net_from_jax(params: dict, cfg) -> dict:
    p = params["params"]
    out: dict = {}
    _conv2d(p["conv1"], "conv1", out)
    _bn(p["bn1"], "bn1", out)
    for li, n_blocks in enumerate(cfg.num_blocks):
        for bi in range(n_blocks):
            blk, pre = p[f"layer{li + 1}_{bi}"], f"layer{li + 1}.{bi}"
            _conv2d(blk["conv1"], f"{pre}.conv1", out)
            _bn(blk["bn1"], f"{pre}.bn1", out)
            _conv2d(blk["conv3"], f"{pre}.conv3", out)
            _bn(blk["bn3"], f"{pre}.bn3", out)
            for i in range(cfg.scale):
                _conv2d(blk[f"conv_{i}"], f"{pre}.convs.{i}", out)
                _bn(blk[f"bn_{i}"], f"{pre}.bns.{i}", out)
            for j in range(cfg.scale - 1):
                if f"fuse_{j}" in blk:
                    _aff(blk[f"fuse_{j}"], f"{pre}.fuse_models.{j}", out)
            if "sc_conv" in blk:
                _conv2d(blk["sc_conv"], f"{pre}.shortcut.0", out)
                _bn(blk["sc_bn"], f"{pre}.shortcut.1", out)
    _conv2d(p["layer3_ds"], "layer3_ds", out)
    _aff(p["fuse34"], "fuse34", out)
    return out


# ---------------------------------------------------------------------------
# BERT (chinese-roberta-wwm-ext-large)
# ---------------------------------------------------------------------------


def bert_from_jax(params: dict, cfg) -> dict:
    """The flax tree of gpt_sovits_tpu/models/bert.py -> the HF `BertModel`
    names without the pooler (the inverse of that module's
    `params_from_torch`)."""
    p = params["params"]
    out = {
        "embeddings.word_embeddings.weight": _t(p["word_embeddings"]["embedding"]),
        "embeddings.position_embeddings.weight": _t(p["position_embeddings"]["embedding"]),
        "embeddings.token_type_embeddings.weight": _t(p["token_type_embeddings"]["embedding"]),
    }
    _ln(p["emb_norm"], "embeddings.LayerNorm", out)
    for i in range(cfg.num_layers):
        lp, pre = p[f"layer_{i}"], f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _dense(lp[name], f"{pre}.attention.self.{name}", out)
        _dense(lp["attn_out"], f"{pre}.attention.output.dense", out)
        _ln(lp["attn_norm"], f"{pre}.attention.output.LayerNorm", out)
        _dense(lp["inter"], f"{pre}.intermediate.dense", out)
        _dense(lp["output"], f"{pre}.output.dense", out)
        _ln(lp["out_norm"], f"{pre}.output.LayerNorm", out)
    return out
