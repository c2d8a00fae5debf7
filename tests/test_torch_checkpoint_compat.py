"""The port's reference-checkpoint helpers against the JAX package's, on
files the tests write: `sniff_sovits_version` (each version header, a zip
file), `merge_lora_state_dict` (both peft key forms, the two refusals),
weight norm folded from both of torch's forms (`weight_g`/`weight_v` and
`parametrizations.weight.original0/1`), and the safetensors reader."""

import copy
import json
import re
import shutil
import struct

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.nn.utils import parametrizations, weight_norm

from gpt_sovits_tpu.utils import checkpoint_compat as jcc
from gpt_sovits_tpu.utils.config import S2Config as JS2Config
from gpt_sovits_tpu_torch import weights
from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from gpt_sovits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn, fold_weight_norm
from gpt_sovits_tpu_torch.train.ckpt import _S2_WEIGHT_NORM
from gpt_sovits_tpu_torch.utils import checkpoint_compat as pcc
from gpt_sovits_tpu_torch.utils.config import S2Config
from gpt_sovits_tpu_torch.utils.safetensors import load_file

torch.set_num_threads(2)

# folding computes g * v / ||v|| in float32 on each side: the sums of squares
# run in other orders (numpy, torch), so folded weights agree to a few ulps
FOLD_RTOL = 1e-6
TINY_S2 = dict(spec_channels=65, segment_size=8, inter_channels=16, hidden_channels=16, filter_channels=32,
               n_heads=2, n_layers=2, kernel_size=3, upsample_rates=(4, 4), upsample_initial_channel=32,
               upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
               gin_channels=16, mrte_hidden=16, ssl_dim=24, n_codes=20, sv_dim=24)


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """The files a test writes are deleted when it ends, passed or failed."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# sniffing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head", [b"00", b"01", b"02", b"03", b"04", b"05", b"06"])
def test_sniff_each_header_equals_jax(tmp_path, head):
    path = tmp_path / "s2.pth"
    path.write_bytes(head + bytes(np.random.default_rng(0).integers(0, 256, 9000, dtype=np.uint8)))
    got = pcc.sniff_sovits_version(str(path))
    assert got == jcc.sniff_sovits_version(str(path)) == jcc.HEAD2VERSION[head]


def test_sniff_zip_file_by_size_and_tables_copied(tmp_path):
    path = tmp_path / "s2.pth"
    torch.save({"weight": {"a": torch.zeros(3)}}, path)  # a zip: "PK", small, so v1
    assert pcc.sniff_sovits_version(str(path)) == jcc.sniff_sovits_version(str(path)) == ("v1", "v1", False)
    assert pcc.HEAD2VERSION == jcc.HEAD2VERSION and pcc.HASH_PRETRAINED == jcc.HASH_PRETRAINED


# ---------------------------------------------------------------------------
# LoRA merge
# ---------------------------------------------------------------------------


def _lora_case(default: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    tgts = ["cfm.estimator.blocks.0.attn.to_q", "cfm.estimator.blocks.0.attn.to_out.0"]
    base = {f"{t}.weight": torch.randn(8, 6, generator=g) for t in tgts}
    base["cfm.estimator.norm.weight"] = torch.randn(8, generator=g)
    sfx = ".default" if default else ""
    lora = {}
    for t in tgts:
        peft = t.replace("cfm.", "cfm.base_model.model.", 1)
        lora[f"{peft}.lora_A{sfx}.weight"] = torch.randn(3, 6, generator=g).half()
        lora[f"{peft}.lora_B{sfx}.weight"] = torch.randn(8, 3, generator=g).half()
    # a base weight the export carries under peft's base_layer name
    lora["cfm.base_model.model.estimator.norm.base_layer.weight"] = torch.randn(8, generator=g)
    return lora, base


@pytest.mark.parametrize("default", [True, False])
def test_merge_lora_equals_jax(default):
    lora, base = _lora_case(default)
    got = pcc.merge_lora_state_dict(lora, base)
    want = jcc.merge_lora_state_dict(lora, base)
    assert got.keys() == want.keys()
    for k, v in want.items():
        v = np.asarray(v.float() if torch.is_tensor(v) else v, np.float32)
        assert rel(got[k].float(), v) < 1e-6, k
    a = lora[[k for k in lora if ".to_q.lora_A" in k][0]].float()
    b = lora[[k for k in lora if ".to_q.lora_B" in k][0]].float()
    w = "cfm.estimator.blocks.0.attn.to_q.weight"
    torch.testing.assert_close(got[w], base[w] + b @ a, rtol=0, atol=1e-5)
    assert torch.equal(got["cfm.estimator.norm.weight"], lora["cfm.base_model.model.estimator.norm.base_layer.weight"])


def test_merge_lora_refusals_equal_jax():
    lora, base = _lora_case(True)
    half = {k: v for k, v in lora.items() if "to_q.lora_B" not in k}
    for mod in (pcc, jcc):
        with pytest.raises(ValueError, match="incomplete LoRA pair"):
            mod.merge_lora_state_dict(half, base)
    no_target = {k: v for k, v in base.items() if "to_out" not in k}
    for mod in (pcc, jcc):
        with pytest.raises(KeyError, match="missing from base"):
            mod.merge_lora_state_dict(lora, no_target)


# ---------------------------------------------------------------------------
# weight norm in both of torch's forms
# ---------------------------------------------------------------------------


def _normed(module, form: str, dim: int = 0):
    """`module` under torch's weight norm: the older hook form or the newer
    parametrization; -> (its state dict, the weight torch computes)."""
    (weight_norm if form == "hook" else parametrizations.weight_norm)(module, dim=dim)
    return module.state_dict(), module.weight.detach().clone()


@pytest.mark.parametrize("form", ["hook", "parametrizations"])
@pytest.mark.parametrize("dim", [0, 2])
def test_fold_both_forms_give_torchs_weight(form, dim):
    torch.manual_seed(dim)
    conv = nn.Conv1d(8, 16, 5, groups=2)
    with torch.no_grad():
        conv.weight.mul_(torch.rand(16, 1, 1) * 3)  # rows of different norms
    sd, w = _normed(conv, form, dim)
    names = {"hook": ("weight_g", "weight_v"),
             "parametrizations": ("parametrizations.weight.original0", "parametrizations.weight.original1")}[form]
    assert set(sd) == {*names, "bias"}, sorted(sd)
    folded = fold_weight_norm(sd, dim=dim)
    assert set(folded) == {"weight", "bias"}
    torch.testing.assert_close(folded["weight"], w, rtol=FOLD_RTOL, atol=1e-7)


def _s2_pair(version: str):
    kw = dict(TINY_S2, version=version, **({"gin_channels": 24} if version == "v2ProPlus" else {}))
    torch.manual_seed(1)
    return SynthesizerTrn(S2Config(**kw)), JS2Config(**kw)


@pytest.mark.parametrize("form", ["hook", "parametrizations"])
@pytest.mark.parametrize("version", ["v2", "v2ProPlus"])
def test_s2_loads_both_forms_as_jax(form, version):
    model, jcfg = _s2_pair(version)
    normed = copy.deepcopy(model)
    n = 0
    for name, mod in normed.named_modules():
        if _S2_WEIGHT_NORM.fullmatch(name + ".weight"):
            (weight_norm if form == "hook" else parametrizations.weight_norm)(mod)
            n += 1
    assert n > 10
    sd = normed.state_dict()
    assert any(re.search(r"\.(weight_g|original0)$", k) for k in sd)
    port = SynthesizerTrn(model.cfg)
    port.load_state_dict(sd)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=FOLD_RTOL, atol=1e-7, msg=k)
    via_jax = SynthesizerTrn(model.cfg)
    params = jcc.s2_params_from_torch(sd, jcfg)
    via_jax.load_state_dict(weights.s2_from_jax(params, model.cfg))
    for k, v in via_jax.state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=FOLD_RTOL, atol=1e-7, msg=k)


@pytest.mark.parametrize("form", ["hook", "parametrizations"])
def test_discriminators_and_bigvgan_load_both_forms(form):
    torch.manual_seed(2)
    wrap = weight_norm if form == "hook" else parametrizations.weight_norm
    for plain, fresh in ((MultiPeriodDiscriminator((2, 3)), MultiPeriodDiscriminator((2, 3))),
                         (BigVGAN(BigVGANConfig(upsample_initial_channel=64), use_kernel=False),
                          BigVGAN(BigVGANConfig(upsample_initial_channel=64), use_kernel=False))):
        normed = copy.deepcopy(plain)
        for mod in list(normed.modules()):
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)) and mod.weight.numel():
                wrap(mod)
        sd = normed.state_dict()
        assert sum(k.endswith(("weight_g", "original0")) for k in sd) > 5
        fresh.load_state_dict(sd)
        for k, v in plain.state_dict().items():
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=FOLD_RTOL, atol=1e-7, msg=k)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

_CODES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int64: "I64"}


def write_safetensors(path, tensors: dict, metadata: dict | None = None) -> None:
    """The format by hand: an 8-byte little-endian header length, the JSON
    header (dtype, shape, data_offsets), then the raw bytes."""
    header, blobs, off = {}, [], 0
    if metadata is not None:
        header["__metadata__"] = metadata
    for name, t in tensors.items():
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def test_safetensors_reader_round_trip(tmp_path):
    g = torch.Generator().manual_seed(3)
    tensors = {"a.f32": torch.randn(3, 4, generator=g), "b.f16": torch.randn(5, generator=g).half(),
               "c.bf16": torch.randn(2, 3, 2, generator=g).bfloat16(), "d.i64": torch.arange(-3, 4),
               "e.scalar": torch.tensor(2.5), "f.empty": torch.zeros(0, 4)}
    write_safetensors(tmp_path / "m.safetensors", tensors, {"format": "pt"})
    got = load_file(str(tmp_path / "m.safetensors"))
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    bad = tmp_path / "bad.safetensors"
    head = json.dumps({"x": {"dtype": "I32", "shape": [2], "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(struct.pack("<Q", len(head)) + head + bytes(8))
    with pytest.raises(ValueError, match="I32"):
        load_file(str(bad))
