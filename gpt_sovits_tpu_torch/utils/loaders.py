"""Model factories: the port's modules with their weights loaded from the
reference project's checkpoint files (port of
gpt_sovits_tpu/utils/loaders.py). Where the JAX loaders return `(model,
params)`, these return the module with its weights in it, on the CPU;
`build_pipeline` and `TTSPipeline` move them to the device.

Files read (each in the reference's own container and key layout):
  * S1: a GPT `.ckpt`/`.pth` ({"weight"} or a lightning {"state_dict"}, the
    `model.` prefix or not), the port's `.npz` export (reference names,
    train/ckpt.py `export_weights`) or the JAX package's (flax paths);
  * S2: a SoVITS `.pth` (version header or zip; a v3/v4 LoRA export merged
    onto `lora_base_path`);
  * CNHuBERT: an HF directory with `pytorch_model.bin` or `model.safetensors`;
  * chinese-roberta: an HF directory with `pytorch_model.bin` and `vocab.txt`;
  * ERes2NetV2: the speaker-verification `.ckpt` (a plain state dict);
  * vocoders: v3's BigVGAN file ({"generator"}), v4's state dict.
Weight norm is folded at load in both of torch's forms. `path=None` gives
a model whose weights come from the global generator seeded with SEED (the
JAX loaders initialize from PRNGKey(0): by design the two differ).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch

from gpt_sovits_tpu_torch.utils.config import S1Config, s2_config_for_version

SEED = 0  # the random models' (path=None) generator seed

# keys of the reference files that the JAX mappings never read
HUBERT_UNREAD = ("masked_spec_embed",)
BERT_UNREAD_PREFIXES = ("cls.", "pooler.")
BERT_UNREAD = ("embeddings.position_ids",)
BIGVGAN_UNREAD_SUFFIXES = (".upsample.filter", ".downsample.lowpass.filter")  # the fixed anti-aliasing filters


@contextlib.contextmanager
def _seeded():
    """Module initialization from the global CPU generator seeded with SEED,
    leaving the caller's generator state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        yield


def _floats(sd: dict) -> dict:
    return {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v) for k, v in sd.items()}


def _npz_state(path: str) -> tuple[dict, bool]:
    """An `.npz` export -> (tensors by key, is the JAX layout): the JAX
    package keys by flax paths (`a/b/kernel`), the port by reference names."""
    data = np.load(path, allow_pickle=False)
    keys = [k for k in data.files if k != "__meta__"]
    sd = {k: torch.from_numpy(np.array(data[k], np.float32 if data[k].dtype.kind == "f" else data[k].dtype))
          for k in keys}
    return sd, any("/" in k for k in keys)


def _tree(flat: dict) -> dict:
    """flax paths -> the nested parameter tree of numpy arrays."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    return tree


def load_s1(path: Optional[str] = None, cfg: S1Config = S1Config()):
    """S1 (T2SDecoder) from a reference GPT `.ckpt`/`.pth`, or an `.npz`
    export of the port or of the JAX package; random (SEED) when `path` is
    None."""
    from gpt_sovits_tpu_torch.models.t2s import T2SDecoder

    with _seeded():
        model = T2SDecoder(cfg)
    if path is None:
        return model
    if path.endswith(".npz"):
        sd, jax_layout = _npz_state(path)
        if jax_layout:
            from gpt_sovits_tpu_torch.weights import s1_from_jax

            sd = s1_from_jax({"params": _tree(sd)}, cfg)
    else:
        from gpt_sovits_tpu_torch.train.ckpt import load_torch_checkpoint

        ckpt = load_torch_checkpoint(path)
        sd = ckpt.get("weight", ckpt.get("state_dict", ckpt))
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    model.load_state_dict(_floats(sd))
    return model


def load_s2(path: Optional[str] = None, version: Optional[str] = None, *, lora_base_path: Optional[str] = None):
    """S2 (SynthesizerTrn, or SynthesizerTrnV3 for v3/v4) from a reference
    SoVITS `.pth` -> (model, version). The version is sniffed from the
    file unless `version` is given. A LoRA export (a v3/v4 fine-tune) needs
    `lora_base_path`, the pretrained SoVITS file it was trained from; its
    deltas are merged at load (TTS.py:552-572)."""
    from gpt_sovits_tpu_torch.models.v3 import SynthesizerTrnV3
    from gpt_sovits_tpu_torch.models.vits import SynthesizerTrn

    is_lora = False
    if path is not None:
        from gpt_sovits_tpu_torch.utils.checkpoint_compat import sniff_sovits_version

        _, sniffed, is_lora = sniff_sovits_version(path)
        version = version or sniffed
    version = version or "v2"
    cfg = s2_config_for_version(version)
    with _seeded():
        model = SynthesizerTrnV3(cfg) if cfg.is_cfm else SynthesizerTrn(cfg)
    if path is None:
        return model, version
    from gpt_sovits_tpu_torch.train.ckpt import load_torch_checkpoint
    from gpt_sovits_tpu_torch.utils.checkpoint_compat import merge_lora_state_dict

    ckpt = load_torch_checkpoint(path)
    sd = ckpt.get("weight", ckpt)
    if is_lora:
        if lora_base_path is None:
            raise ValueError(
                f"{path} is a LoRA fine-tune export; pass lora_base_path= the "
                "pretrained SoVITS file it was trained from (the reference "
                "merges onto pretrained_models/..., TTS.py:552-572)"
            )
        base = load_torch_checkpoint(lora_base_path)
        sd = merge_lora_state_dict(sd, base.get("weight", base))
    model.load_state_dict(_floats(sd))  # drops enc_q.*, folds weight norm
    return model, version


def load_hubert(path: Optional[str] = None):
    """CNHuBERT (HubertEncoder) from an HF model directory
    (chinese-hubert-base: `pytorch_model.bin` or `model.safetensors`)."""
    from gpt_sovits_tpu_torch.models.hubert import HubertConfig, HubertEncoder
    from gpt_sovits_tpu_torch.models.vits import fold_weight_norm

    with _seeded():
        model = HubertEncoder(HubertConfig())
    if path is None:
        return model
    bin_path = None
    for name in ("pytorch_model.bin", "model.safetensors"):
        cand = os.path.join(path, name)
        if os.path.exists(cand):
            bin_path = cand
            break
    if bin_path is None:
        raise FileNotFoundError(f"no weights found under {path}")
    if bin_path.endswith(".safetensors"):
        from gpt_sovits_tpu_torch.utils.safetensors import load_file

        sd = load_file(bin_path)
    else:
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("hubert."): v for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if k not in HUBERT_UNREAD}
    # HF's pos_conv is weight_norm(conv, dim=2): the norm over axes (0, 1)
    model.load_state_dict(_floats(fold_weight_norm(sd, dim=2)))
    return model


def load_bert(path: Optional[str] = None):
    """chinese-roberta-wwm-ext-large from an HF directory
    (`pytorch_model.bin`, `vocab.txt`) -> (BertEncoder, BertTokenizer), or
    (None, None) without a path. The tokenizer is the port's own WordPiece
    over `vocab.txt`."""
    if path is None:
        return None, None
    from gpt_sovits_tpu_torch.models.bert import BertConfig, BertEncoder
    from gpt_sovits_tpu_torch.text.bert_tokenizer import BertTokenizer

    tokenizer = BertTokenizer(os.path.join(path, "vocab.txt"))
    with _seeded():
        model = BertEncoder(BertConfig())
    sd = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    sd = {k.removeprefix("bert."): v for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if k not in BERT_UNREAD and not k.startswith(BERT_UNREAD_PREFIXES)}
    model.load_state_dict(_floats(sd))
    return model, tokenizer


def load_sv(path: Optional[str] = None):
    """ERes2NetV2 speaker embedder (width 24, scale 4, expansion 4) from the
    reference's `.ckpt`. Its forward ends at `fuse34`, as the reference's
    forward3: the layers after it and BatchNorm's `num_batches_tracked`
    are not read."""
    from gpt_sovits_tpu_torch.models.eres2net import ERes2NetConfig, ERes2NetV2

    with _seeded():
        model = ERes2NetV2(ERes2NetConfig(base_width=24, scale=4, expansion=4))
    if path is None:
        return model
    sd = torch.load(path, map_location="cpu", weights_only=False)
    children = {name for name, _ in model.named_children()}
    sd = {k: v for k, v in sd.items() if k.split(".")[0] in children and not k.endswith(".num_batches_tracked")}
    model.load_state_dict(_floats(sd))
    return model


def load_vocoder(vocoder_path: Optional[str], version: str = "v3"):
    """The v3/v4 vocoder: BigVGAN (24 kHz, x256) for v3, from the file's
    `generator` entry; the x480 48 kHz Generator for v4 (TTS.py:601-660),
    from its state dict. Random (SEED) without a path."""
    with _seeded():
        if version == "v3":
            from gpt_sovits_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig

            voc = BigVGAN(BigVGANConfig())
        else:
            from gpt_sovits_tpu_torch.models.vits import Generator
            from gpt_sovits_tpu_torch.utils.config import vocoder_v4_config

            vcfg = vocoder_v4_config()
            voc = Generator(vcfg, in_channels=vcfg.cfm_mel_channels, use_post_bias=True, conditioned=False)
    if vocoder_path:
        from gpt_sovits_tpu_torch.models.vits import fold_weight_norm

        sd = torch.load(vocoder_path, map_location="cpu", weights_only=False)
        if version == "v3":
            sd = {k: v for k, v in sd.get("generator", sd).items() if not k.endswith(BIGVGAN_UNREAD_SUFFIXES)}
        voc.load_state_dict(_floats(fold_weight_norm(sd)))
    return voc


def _serving_t_chunk(version: str, device) -> int:
    """The CFM window: `GSVT_T_CHUNK` when set, else
    infer/pipeline.py `serving_t_chunk` (1024 on a card, the reference's
    934 (v3) / 1000 (v4) on the CPU)."""
    from gpt_sovits_tpu_torch.infer.pipeline import serving_t_chunk

    env = os.environ.get("GSVT_T_CHUNK")
    return int(env) if env else serving_t_chunk(version, device)


def build_v3_bundle(s2_path: str, vocoder_path: Optional[str], version: str = "v3", *, sample_steps: int = 32,
                    device=None):
    """The v3/v4 serving bundle: the CFM synthesizer and its vocoder
    (reference TTS.init_vocoder constants, TTS.py:601-660)."""
    from gpt_sovits_tpu_torch import resolve_device
    from gpt_sovits_tpu_torch.infer.pipeline import V3Bundle
    from gpt_sovits_tpu_torch.utils.config import MEL_V3, MEL_V4

    model, version = load_s2(s2_path, version)
    voc = load_vocoder(vocoder_path, version)
    t_chunk = _serving_t_chunk(version, resolve_device(device))
    if version == "v3":
        return V3Bundle(model=model, vocoder=voc, mel_cfg=MEL_V3, t_ref=468, t_chunk=t_chunk, out_sr=24000,
                        sample_steps=sample_steps)
    return V3Bundle(model=model, vocoder=voc, mel_cfg=MEL_V4, t_ref=500, t_chunk=t_chunk, out_sr=48000,
                    sample_steps=sample_steps)


def build_pipeline(
    *,
    s1_path: Optional[str] = None,
    s2_path: Optional[str] = None,
    version: Optional[str] = None,
    hubert_path: Optional[str] = None,
    bert_path: Optional[str] = None,
    sv_path: Optional[str] = None,
    infer_cfg=None,
    s1_weight_quant: Optional[str] = None,  # None: int8 on a card
    s1_kv_quant: Optional[str] = None,
    device=None,  # None: CUDA (raises without a card); "cpu" for the CPU
):
    """A TTSPipeline from checkpoint paths in the reference's formats (v1/v2/
    v2Pro/v2ProPlus; v3/v4 go through build_v3_bundle, as in the JAX
    package)."""
    from gpt_sovits_tpu_torch.infer.pipeline import TTSPipeline
    from gpt_sovits_tpu_torch.utils.config import InferenceConfig, MelConfig

    s1 = load_s1(s1_path)
    s2, version = load_s2(s2_path, version)
    if version in ("v3", "v4"):
        raise NotImplementedError(
            "v3/v4 serving via build_pipeline needs the vocoder checkpoint; "
            "use build_v3_bundle(...) and pass v3_bundle to TTSPipeline"
        )
    hubert = load_hubert(hubert_path)
    bert, tokenizer = load_bert(bert_path)
    sv = load_sv(sv_path) if version in ("v2Pro", "v2ProPlus") else None
    return TTSPipeline(
        s1_model=s1, s2_model=s2, hubert_model=hubert, sv_model=sv, bert_model=bert, bert_tokenizer=tokenizer,
        mel_cfg=MelConfig(), infer_cfg=infer_cfg or InferenceConfig(version=version),
        s1_weight_quant=s1_weight_quant, s1_kv_quant=s1_kv_quant, device=device,
    )
