"""The port's loaders (utils/loaders.py) against the JAX package's
(gpt_sovits_tpu/utils/loaders.py) on the same files, written by the tests
in the reference's containers and key layouts from seeded full-width
weights (the JAX loaders take no width). Parameters only, no forward:
JAX loads the file, the port loads the same file, and `*_from_jax` of
JAX's parameters equals the port's state dict tensor for tensor, exactly,
except where weight norm is folded (each side computes g * v / ||v|| in
float32 with its own order of sums: FOLD_RTOL). Also the reference config
readers on files the tests write. Each file is written once a module and
deleted when its tests end."""

import dataclasses
import json
import re
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.nn.utils import parametrizations, weight_norm

import chip_smoke
from gpt_sovits_tpu.models.bigvgan import BigVGANConfig as JBigVGANConfig
from gpt_sovits_tpu.train import ckpt as jckpt
from gpt_sovits_tpu.utils import config as jconfig
from gpt_sovits_tpu.utils import loaders as jl
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.bert import BertConfig, BertEncoder
from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.models.eres2net import ERes2NetConfig, ERes2NetV2
from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
from gpt_sovits_tpu_torch.models.t2s import T2SDecoder
from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
from gpt_sovits_tpu_torch.models.vits import Generator, SynthesizerTrn
from gpt_sovits_tpu_torch.train import ckpt as ckpt_io
from gpt_sovits_tpu_torch.utils import config as pconfig
from gpt_sovits_tpu_torch.utils import loaders as pl
from test_torch_checkpoint_compat import write_safetensors

torch.set_num_threads(4)

FOLD_RTOL = 1e-6  # folded weight norm, numpy vs torch float32 sums (test_torch_checkpoint_compat.py)


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def fp16(sd: dict) -> dict:
    """The container's rounding: float tensors through float16."""
    return {k: v.half().float() if v.is_floating_point() else v for k, v in sd.items()}


def assert_same(got: dict, want: dict, folded=()):
    """Tensor for tensor: exact, or within FOLD_RTOL for the names in `folded`."""
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))[:10]
    for k, v in want.items():
        g = got[k].float() if got[k].is_floating_point() else got[k]
        w = v.float() if v.is_floating_point() else v
        if k in folded:
            torch.testing.assert_close(g, w, rtol=FOLD_RTOL, atol=1e-7, msg=k)
        else:
            assert torch.equal(g, w), k


def split_weight_norm(sd: dict, names, seed: int = 0) -> dict:
    """`<p>.weight` -> `<p>.weight_g`/`<p>.weight_v` (dim 0) for the names in
    `names`: v = w times a positive factor a row, g = ||w||, so g * v / ||v||
    is w."""
    g_ = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if k in names:
            w = v.float()
            p = k[: -len("weight")]
            axes = tuple(range(1, w.ndim))
            out[p + "weight_g"] = torch.sqrt((w**2).sum(dim=axes, keepdim=True))
            out[p + "weight_v"] = w * (0.5 + torch.rand((w.shape[0],) + (1,) * (w.ndim - 1), generator=g_))
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("loaders")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# S1
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def s1(files):
    torch.manual_seed(11)
    sd = T2SDecoder(pconfig.S1Config()).state_dict()
    ckpt = ckpt_io.save_reference_pth(sd, str(files / "s1.ckpt"), config={"model": {}}, info="e1")
    lightning = files / "s1_lightning.ckpt"
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}, "epoch": 3}, lightning)
    return sd, ckpt, str(lightning)


@pytest.mark.parametrize("which", ["weight", "lightning"])
def test_s1_ckpt_equals_jax(s1, which):
    sd, ckpt, lightning = s1
    path = ckpt if which == "weight" else lightning
    _, jparams = jl.load_s1(path)
    port = pl.load_s1(path).state_dict()
    assert_same(port, weights.s1_from_jax(np_tree(jparams), pconfig.S1Config()))
    assert_same(port, fp16(sd) if which == "weight" else sd)


def test_s1_npz_both_layouts(s1, files):
    sd, ckpt, _ = s1
    port_npz = ckpt_io.export_weights(sd, str(files / "s1_port.npz"), config={"model": "s1"}, info="e1")
    _, jparams = jl.load_s1(ckpt)  # the JAX loader reads the same fp16 tensors from the .ckpt
    assert_same(pl.load_s1(port_npz).state_dict(), weights.s1_from_jax(np_tree(jparams), pconfig.S1Config()))
    jax_npz = jckpt.export_weights(jparams["params"], str(files / "s1_jax.npz"), config={}, info="e1")
    _, jparams2 = jl.load_s1(jax_npz)
    got = pl.load_s1(jax_npz).state_dict()
    assert_same(got, weights.s1_from_jax(np_tree(jparams2), pconfig.S1Config()))
    assert_same(got, fp16(sd))


def test_s1_random_is_seeded():
    """path=None: weights from the global generator seeded with SEED, the
    caller's generator state left as it was."""
    torch.manual_seed(pl.SEED)
    want = T2SDecoder(pconfig.S1Config()).state_dict()
    torch.manual_seed(5)
    state = torch.get_rng_state()
    assert_same(pl.load_s1(None).state_dict(), want)
    assert torch.equal(torch.get_rng_state(), state)


# ---------------------------------------------------------------------------
# S2: v2, v2ProPlus, v4 and a LoRA export
# ---------------------------------------------------------------------------


def _wn_names(sd):
    return {k[: -len("weight_g")] + "weight" for k in sd if k.endswith("weight_g")}


@pytest.mark.parametrize("version", ["v2", "v2ProPlus"])
def test_s2_equals_jax(files, version):
    cfg = pconfig.s2_config_for_version(version)
    torch.manual_seed(12)
    ref = ckpt_io.s2_reference_state(SynthesizerTrn(cfg).state_dict())
    path = ckpt_io.save_reference_pth(ref, str(files / f"s2_{version}.pth"), model_version=version)
    jmodel, jparams, jver = jl.load_s2(path, version)
    model, ver = pl.load_s2(path, version)
    assert ver == jver == version and type(model) is SynthesizerTrn
    via_jax = SynthesizerTrn(cfg)
    via_jax.load_state_dict(weights.s2_from_jax(np_tree(jparams), cfg))
    folded = _wn_names(ref)
    assert len(folded) > 20
    assert_same(model.state_dict(), via_jax.state_dict(), folded)
    expect = SynthesizerTrn(cfg)
    expect.load_state_dict(fp16(ref))  # the seeded weights after the container's fp16 rounding
    assert_same(model.state_dict(), expect.state_dict())
    if version == "v2ProPlus":  # the `06` header names the version
        assert pl.load_s2(path)[1] == jl.load_s2(path)[2] == "v2ProPlus"


@pytest.fixture(scope="module")
def v4_file(files):
    cfg = pconfig.s2_config_for_version("v4")
    torch.manual_seed(13)
    ref = ckpt_io.s2_reference_state(SynthesizerTrnV3(cfg).state_dict())
    return cfg, ref, ckpt_io.save_reference_pth(ref, str(files / "s2_v4.pth"), model_version="v4")


def test_v4_export_needs_a_base_in_both(v4_file):
    """The `04` header reads as a LoRA export (HEAD2VERSION), so a full v4
    export loads only with a base, in both packages."""
    cfg, ref, path = v4_file
    for load in (jl.load_s2, pl.load_s2):
        with pytest.raises(ValueError, match="LoRA fine-tune export"):
            load(path)
    with pytest.raises(ValueError, match="LoRA fine-tune export"):
        pl.build_v3_bundle(path, None, "v4", device="cpu")
    _, jparams, _ = jl.load_s2(path, lora_base_path=path)
    model, ver = pl.load_s2(path, lora_base_path=path)
    assert ver == "v4" and type(model) is SynthesizerTrnV3
    via_jax = SynthesizerTrnV3(cfg)
    via_jax.load_state_dict(weights.s2v3_from_jax(np_tree(jparams), cfg))
    assert_same(model.state_dict(), via_jax.state_dict(), _wn_names(ref))


def test_v4_lora_export_merged_onto_its_base(v4_file, files):
    cfg, ref, base = v4_file
    g = torch.Generator().manual_seed(14)
    lora, r = {}, 4
    for i in (0, 21):
        for proj in ("to_q", "to_v", "to_out.0"):
            pre = f"cfm.base_model.model.estimator.transformer_blocks.{i}.attn.{proj}"
            lora[f"{pre}.lora_A.default.weight"] = 0.1 * torch.randn(r, 1024, generator=g)
            lora[f"{pre}.lora_B.default.weight"] = 0.1 * torch.randn(1024, r, generator=g)
    lora["cfm.base_model.model.estimator.norm_out.linear.base_layer.bias"] = torch.randn(2048, generator=g)
    path = ckpt_io.save_reference_pth(lora, str(files / "s2_v4_lora.pth"), model_version="v4",
                                      config={"lora_rank": r})
    for load in (jl.load_s2, pl.load_s2):
        with pytest.raises(ValueError, match="lora_base_path"):
            load(path)
    _, jparams, _ = jl.load_s2(path, lora_base_path=base)
    model, _ = pl.load_s2(path, lora_base_path=base)
    via_jax = SynthesizerTrnV3(cfg)
    via_jax.load_state_dict(weights.s2v3_from_jax(np_tree(jparams), cfg))
    got = model.state_dict()
    name = "cfm.estimator.transformer_blocks.21.attn.to_v.weight"
    pre = "cfm.base_model.model.estimator.transformer_blocks.21.attn.to_v"
    delta = lora[f"{pre}.lora_B.default.weight"].half().float() @ lora[f"{pre}.lora_A.default.weight"].half().float()
    torch.testing.assert_close(got[name], ref[name].half().float() + delta, rtol=0, atol=1e-5)
    # numpy's and torch's float32 matmuls sum in other orders: the merged targets within 1e-6
    merged = {k for k in got if re.search(r"transformer_blocks\.(0|21)\.attn\.(to_q|to_v|to_out\.0)\.weight$", k)}
    assert len(merged) == 6
    assert_same(got, via_jax.state_dict(), _wn_names(ref) | merged)


# ---------------------------------------------------------------------------
# CNHuBERT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hubert(files):
    torch.manual_seed(15)
    sd = HubertEncoder(HubertConfig()).state_dict()
    conv = nn.Conv1d(768, 768, 128, padding=64, groups=16)
    conv.load_state_dict({"weight": sd["encoder.pos_conv_embed.conv.weight"],
                          "bias": sd["encoder.pos_conv_embed.conv.bias"]})
    dirs = {}
    for form, wrap in (("parametrizations", parametrizations.weight_norm), ("hook", weight_norm)):
        c = nn.Conv1d(768, 768, 128, padding=64, groups=16)
        c.load_state_dict(conv.state_dict())
        with torch.no_grad():  # rows of different norms on the norm's axes
            c.weight.mul_(0.5 + torch.rand(1, 1, 128))
        wrap(c, dim=2)  # HF's Hubert: weight_norm(conv, name="weight", dim=2)
        wn = {f"encoder.pos_conv_embed.conv.{k}": v for k, v in c.state_dict().items()}
        out = {"hubert." + k: v for k, v in sd.items() if not k.startswith("encoder.pos_conv_embed.conv.")}
        out.update({"hubert." + k: v for k, v in wn.items()})
        out["hubert.masked_spec_embed"] = torch.rand(768)
        d = files / f"hubert_{form}"
        d.mkdir()
        torch.save(out, d / "pytorch_model.bin")
        dirs[form] = (str(d), out, c.weight.detach().clone())
    st = files / "hubert_safetensors"
    st.mkdir()
    write_safetensors(st / "model.safetensors", dirs["parametrizations"][1])
    dirs["safetensors"] = (str(st),)
    return dirs


def test_hubert_parametrizations_form_equals_jax(hubert):
    path, sd, w = hubert["parametrizations"]
    _, jparams = jl.load_hubert(path)
    got = pl.load_hubert(path).state_dict()
    pos = "encoder.pos_conv_embed.conv.weight"
    assert_same(got, weights.hubert_from_jax(np_tree(jparams), HubertConfig()), {pos})
    torch.testing.assert_close(got[pos], w, rtol=FOLD_RTOL, atol=1e-7)  # torch's own weight_norm(dim=2)


def test_hubert_weight_g_form_equals_torchs_weight_norm(hubert):
    """Older transformers saves `weight_g`/`weight_v`: the port folds them
    over dim 2 as torch does; JAX's mapping raises KeyError on them (a known
    problem on the JAX side)."""
    path, sd, w = hubert["hook"]
    got = pl.load_hubert(path).state_dict()
    torch.testing.assert_close(got["encoder.pos_conv_embed.conv.weight"], w, rtol=FOLD_RTOL, atol=1e-7)
    plain = {k.removeprefix("hubert."): v for k, v in sd.items() if "pos_conv" not in k and "masked" not in k}
    assert_same({k: v for k, v in got.items() if "pos_conv_embed.conv.weight" not in k},
                {**plain, "encoder.pos_conv_embed.conv.bias": sd["hubert.encoder.pos_conv_embed.conv.bias"]})
    with pytest.raises(KeyError):
        jl.load_hubert(path)


def test_hubert_safetensors_equals_bin(hubert):
    (path,) = hubert["safetensors"]
    got = pl.load_hubert(path).state_dict()
    assert_same(got, pl.load_hubert(hubert["parametrizations"][0]).state_dict())
    _, jparams = jl.load_hubert(path)  # the JAX loader reads it through the safetensors package
    assert_same(got, weights.hubert_from_jax(np_tree(jparams), HubertConfig()), {"encoder.pos_conv_embed.conv.weight"})
    with pytest.raises(FileNotFoundError):
        pl.load_hubert(str(path) + "_missing")


# ---------------------------------------------------------------------------
# BERT, ERes2NetV2, vocoders
# ---------------------------------------------------------------------------


def test_bert_equals_jax(files):
    d = files / "chinese-roberta-wwm-ext-large"
    d.mkdir()
    torch.manual_seed(16)
    sd = BertEncoder(BertConfig()).state_dict()
    g = torch.Generator().manual_seed(16)
    out = {"bert." + k: v for k, v in sd.items()}
    out.update({"bert.embeddings.position_ids": torch.arange(512)[None],
                "bert.pooler.dense.weight": torch.randn(1024, 1024, generator=g),
                "bert.pooler.dense.bias": torch.zeros(1024), "cls.predictions.bias": torch.zeros(21128),
                "cls.predictions.transform.dense.weight": torch.randn(1024, 1024, generator=g)})
    torch.save(out, d / "pytorch_model.bin")
    del out
    (d / "vocab.txt").write_text("\n".join(chip_smoke.bert_vocab()) + "\n", encoding="utf-8")
    # the JAX loader's AutoTokenizer wants a config beside the vocabulary
    (d / "config.json").write_text(json.dumps({"model_type": "bert", "vocab_size": 21128}))
    jmodel, jparams, jtok = jl.load_bert(str(d))
    model, tok = pl.load_bert(str(d))
    assert_same(model.state_dict(), weights.bert_from_jax(np_tree(jparams), BertConfig()))
    del jparams
    assert_same(model.state_dict(), sd)
    text = "今天是二零二四年三月五日，银行行长说你好好想想。"
    assert tok(text)["input_ids"].tolist() == jtok(text, return_tensors="np")["input_ids"].tolist()
    assert pl.load_bert(None) == (None, None)


def test_sv_equals_jax(files):
    cfg = ERes2NetConfig(base_width=24, scale=4, expansion=4)
    torch.manual_seed(17)
    sd = ERes2NetV2(cfg).state_dict()
    out = dict(sd)
    for k in sd:
        if k.endswith(".running_var"):
            out[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    # the layers after fuse34 (pooling, the embedding layer), which the forward never reaches
    out.update({"seg_1.weight": torch.randn(192, 20480), "seg_1.bias": torch.zeros(192)})
    path = files / "eres2netv2.ckpt"
    torch.save(out, path)
    _, jparams = jl.load_sv(str(path))
    got = pl.load_sv(str(path)).state_dict()
    assert_same(got, weights.eres2net_from_jax(np_tree(jparams), cfg))
    assert_same(got, sd)


def test_bigvgan_equals_jax(files):
    torch.manual_seed(18)
    sd = BigVGAN(BigVGANConfig()).state_dict()
    names = {k for k in sd if re.fullmatch(r"(conv_pre|ups\.\d+\.0|resblocks\.\d+\.convs[12]\.\d+|conv_post)\.weight", k)}
    out = split_weight_norm(sd, names)
    filt = torch.rand(1, 1, 12)
    for k in [k for k in sd if k.endswith(".act.alpha")]:
        pre = k[: -len("act.alpha")]
        out[pre + "upsample.filter"], out[pre + "downsample.lowpass.filter"] = filt, filt
    path = files / "bigvgan_generator.pt"
    torch.save({"generator": out}, path)
    _, jparams = jl.load_vocoder(str(path), "v3")
    got = pl.load_vocoder(str(path), "v3").state_dict()
    assert_same(got, weights.bigvgan_from_jax(np_tree(jparams), JBigVGANConfig()), names)
    assert_same(got, sd, names)


def test_v4_vocoder_equals_jax(files):
    vcfg = pconfig.vocoder_v4_config()
    torch.manual_seed(19)
    sd = Generator(vcfg, in_channels=100, use_post_bias=True, conditioned=False).state_dict()
    names = {k for k in sd if re.fullmatch(r"(ups\.\d+|resblocks\.\d+\.convs[12]\.\d+)\.weight", k)}
    assert len(names) == 5 + 5 * 3 * 6
    path = files / "vocoder.pth"
    torch.save(split_weight_norm(sd, names), path)
    _, jparams = jl.load_vocoder(str(path), "v4")
    got = pl.load_vocoder(str(path), "v4").state_dict()
    assert_same(got, weights.vocoder_v4_from_jax(np_tree(jparams), vcfg), names)
    assert_same(got, sd, names)


# ---------------------------------------------------------------------------
# pipeline assembly, config readers
# ---------------------------------------------------------------------------


def test_build_pipeline_refuses_v3_v4_and_t_chunk(monkeypatch):
    with pytest.raises(NotImplementedError, match="build_v3_bundle"):  # as the JAX package's (loaders.py:254)
        pl.build_pipeline(version="v4", device="cpu")
    assert pl._serving_t_chunk("v3", torch.device("cpu")) == 934
    assert pl._serving_t_chunk("v4", torch.device("cpu")) == 1000
    monkeypatch.setenv("GSVT_T_CHUNK", "512")
    assert pl._serving_t_chunk("v4", torch.device("cpu")) == 512 == jl._serving_t_chunk(1000)


def test_config_readers_equal_jax(tmp_path):
    s2 = tmp_path / "s2.json"
    s2.write_text(json.dumps({"train": {"segment_size": 20480}, "data": {"filter_length": 2048, "hop_length": 640},
                              "model": {"inter_channels": 192, "hidden_channels": 192, "filter_channels": 768,
                                        "n_heads": 2, "n_layers": 6, "upsample_rates": [10, 8, 2, 2, 2],
                                        "upsample_initial_channel": 768, "gin_channels": 1024,
                                        "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                                        "semantic_frame_rate": "25hz", "freeze_quantizer": True}}))
    s1 = tmp_path / "s1longer-v2.yaml"
    s1.write_text("train:\n  epochs: 20\nmodel:\n  vocab_size: 1025\n  phoneme_vocab_size: 732\n  embedding_dim: 512\n"
                  "  hidden_dim: 512\n  head: 16\n  n_layer: 24\n  dropout: 0\n  EOS: 1024\n")
    infer = tmp_path / "tts_infer.yaml"
    infer.write_text("custom:\n  version: v2ProPlus\n  device: cuda\nv4:\n  version: v4\n")
    pairs = [
        (pconfig.s2_config_from_reference_json(str(s2), "v2ProPlus"),
         jconfig.s2_config_from_reference_json(str(s2), "v2ProPlus")),
        (pconfig.s1_config_from_reference_yaml(str(s1)), jconfig.s1_config_from_reference_yaml(str(s1))),
        (pconfig.inference_config_from_reference_yaml(str(infer), "v2"),
         jconfig.inference_config_from_reference_yaml(str(infer), "v2")),
        (pconfig.inference_config_from_reference_yaml(str(infer), "v4"),
         jconfig.inference_config_from_reference_yaml(str(infer), "v4")),
    ]
    for got, want in pairs:
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert {k: v for k, v in g.items() if k in w} == {k: w[k] for k in g if k in w}, (g, w)
    assert pairs[0][0] == pconfig.s2_config_for_version("v2ProPlus")
    assert pairs[2][0].version == "v2ProPlus" and pairs[3][0].version == "v4"
