"""Pretrained model downloader (a copy of gpt_sovits_tpu/utils/download.py).

Counterpart of GPT_SoVITS/download.py + install.sh model fetching: pulls
the reference's published checkpoints from Hugging Face so they can be
loaded through utils/loaders. Pure stdlib; requires network
egress (disabled in some environments — all loaders also accept local
paths).
"""

from __future__ import annotations

import os
import urllib.request

HF_BASE = "https://huggingface.co/lj1995/GPT-SoVITS/resolve/main"

PRETRAINED = {
    "s1": "s1v3.ckpt",
    "s1_v1": "s1bert25hz-2kh-longer-epoch=68e-step=50232.ckpt",
    "s1_v2": "gsv-v2final-pretrained/s1bert25hz-5kh-longer-epoch=12-step=369668.ckpt",
    "s2g_v1": "s2G488k.pth",
    "s2d_v1": "s2D488k.pth",
    "s2g_v2": "gsv-v2final-pretrained/s2G2333k.pth",
    "s2d_v2": "gsv-v2final-pretrained/s2D2333k.pth",
    "s2d_v2pro": "v2Pro/s2Dv2Pro.pth",
    "s2d_v2proplus": "v2Pro/s2Dv2ProPlus.pth",
    "s2g_v2pro": "v2Pro/s2Gv2Pro.pth",
    "s2g_v2proplus": "v2Pro/s2Gv2ProPlus.pth",
    "s2g_v3": "s2Gv3.pth",
    "s2g_v4": "gsv-v4-pretrained/s2Gv4.pth",
    "vocoder_v4": "gsv-v4-pretrained/vocoder.pth",
    "hubert": "chinese-hubert-base/pytorch_model.bin",
    "hubert_config": "chinese-hubert-base/config.json",
    "bert": "chinese-roberta-wwm-ext-large/pytorch_model.bin",
    "bert_config": "chinese-roberta-wwm-ext-large/config.json",
    "bert_tokenizer": "chinese-roberta-wwm-ext-large/tokenizer.json",
    "sv": "sv/pretrained_eres2netv2w24s4ep4.ckpt",
}

BIGVGAN_BASE = "https://huggingface.co/nvidia/bigvgan_v2_24khz_100band_256x/resolve/main"


def download(name: str, dest_dir: str, *, progress: bool = True) -> str:
    """Download one named asset (see PRETRAINED) into dest_dir."""
    rel = PRETRAINED[name]
    url = f"{HF_BASE}/{rel}"
    dest = os.path.join(dest_dir, rel)
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    if os.path.exists(dest):
        return dest

    def _hook(blocks, bs, total):
        if progress and total > 0 and blocks % 256 == 0:
            print(f"\r{name}: {blocks * bs / total:.0%}", end="", flush=True)

    urllib.request.urlretrieve(url, dest, reporthook=_hook)
    if progress:
        print(f"\r{name}: done -> {dest}")
    return dest


def download_all(dest_dir: str, names=None) -> dict[str, str]:
    out = {}
    for name in names or PRETRAINED:
        out[name] = download(name, dest_dir)
    return out


# -- corpus-tool / frontend assets the reference auto-downloads -------------

# G2PWModel bundle (g2pW.onnx + config.py + dicts) — the reference fetches
# it on first zh g2p use (GPT_SoVITS/text/g2pw/onnx_api.py:58-76); the
# extracted dir is what text/g2pw.py:enable() accepts
G2PW_URL = "https://www.modelscope.cn/models/kamiorinn/g2pw/resolve/master/G2PWModel_1.1.zip"

# UVR5 separation weights (roformer/VR/MDX checkpoints) — install.sh
# --download-uvr5 in the reference
UVR5_URL = "https://huggingface.co/XXXXRT/GPT-SoVITS-Pretrained/resolve/main/uvr5_weights.zip"

# FRCRN denoiser checkpoint (tools/cmd-denoise.py's model, fetched by the
# reference via modelscope) — consumed by models/frcrn.py:load_frcrn
FRCRN_URL = "https://www.modelscope.cn/models/damo/speech_frcrn_ans_cirm_16k/resolve/master/pytorch_model.bin"

# funasr ASR models resolve by modelscope id at runtime
# (tools/asr/funasr_asr.py:25-50); listed here so `download --asr` can
# prefetch them when modelscope is installed
ASR_MODELS = {
    "zh": "iic/speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404-pytorch",
    "zh_vad": "iic/speech_fsmn_vad_zh-cn-16k-common-pytorch",
    "zh_punc": "iic/punc_ct-transformer_zh-cn-common-vocab272727-pytorch",
    "yue": "iic/speech_UniASR_asr_2pass-cantonese-CHS-16k-common-vocab1468-tensorflow1-online",
}


def _fetch_zip(url: str, dest_dir: str, marker: str, progress: bool = True) -> str:
    """Download + extract a zip into dest_dir; skip when `marker` exists."""
    import zipfile

    target = os.path.join(dest_dir, marker)
    if os.path.exists(target):
        return target
    os.makedirs(dest_dir, exist_ok=True)
    zpath = os.path.join(dest_dir, os.path.basename(url))
    if not os.path.exists(zpath):
        urllib.request.urlretrieve(url, zpath)
    with zipfile.ZipFile(zpath) as zf:
        for m in zf.namelist():  # refuse path traversal in downloaded zips
            if m.startswith("/") or ".." in m.split("/"):
                raise ValueError(f"unsafe zip member: {m}")
        zf.extractall(dest_dir)
    os.remove(zpath)
    if progress:
        print(f"{marker}: done -> {target}")
    return target


def download_g2pw(dest_dir: str = "pretrained_models", *, progress: bool = True) -> str:
    """Fetch + extract the G2PWModel bundle; returns the model dir to pass
    to gpt_sovits_tpu_torch.text.g2pw.enable()."""
    path = _fetch_zip(G2PW_URL, dest_dir, "G2PWModel_1.1", progress)
    alias = os.path.join(dest_dir, "G2PWModel")
    if not os.path.exists(alias):
        os.symlink(os.path.basename(path), alias)
    return path


def download_uvr5(dest_dir: str = "uvr5_weights", *, progress: bool = True) -> str:
    """Fetch + extract the UVR5 separation weights bundle."""
    return _fetch_zip(UVR5_URL, dest_dir, "uvr5_weights", progress)


def download_frcrn(dest_dir: str = "pretrained_models", *, progress: bool = True) -> str:
    """Fetch the FRCRN denoiser checkpoint; returns the .bin path to pass
    to `cli denoise --ckpt` (or export as GSVT_FRCRN_CKPT)."""
    os.makedirs(dest_dir, exist_ok=True)
    path = os.path.join(dest_dir, "speech_frcrn_ans_cirm_16k.bin")
    if not os.path.exists(path):
        urllib.request.urlretrieve(FRCRN_URL, path)
    if progress:
        print(f"frcrn: done -> {path}")
    return path


def download_asr(dest_dir: str = "asr_models", languages=("zh",), *, progress: bool = True) -> dict[str, str]:
    """Prefetch funasr models via modelscope (runtime fallback: corpus/asr.py
    lets funasr resolve the same ids lazily)."""
    try:
        from modelscope.hub.snapshot_download import snapshot_download
    except ImportError as e:
        raise RuntimeError(
            "modelscope is required to prefetch ASR models; funasr will "
            f"auto-download {ASR_MODELS} at first use instead"
        ) from e
    out = {}
    for lang in languages:
        for key, model_id in ASR_MODELS.items():
            if key == lang or key.startswith(f"{lang}_"):
                out[key] = snapshot_download(model_id, cache_dir=dest_dir)
                if progress:
                    print(f"{key}: done -> {out[key]}")
    return out
