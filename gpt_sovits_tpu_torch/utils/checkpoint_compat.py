"""Reference-checkpoint interop (port of the readers of
gpt_sovits_tpu/utils/checkpoint_compat.py): the version sniffing of the
reference's SoVITS files and the merge of a v3/v4 LoRA export onto its base.

The reference's containers (process_ckpt.py): a 2-byte model-version header
in place of the zip's "PK" magic (my_save2:30, head2version:72-80), the md5
of the first 8 KB for the published pretrained files (:81-97), and fp16
distribution checkpoints {weight, config, info[, lora_rank]} (savee:41).
`load_torch_checkpoint` (train/ckpt.py) reads them.
"""

from __future__ import annotations

import hashlib
import os

import torch

HEAD2VERSION = {
    b"00": ("v1", "v1", False),
    b"01": ("v2", "v2", False),
    b"02": ("v2", "v3", False),
    b"03": ("v2", "v3", True),
    b"04": ("v2", "v4", True),
    b"05": ("v2", "v2Pro", False),
    b"06": ("v2", "v2ProPlus", False),
}

HASH_PRETRAINED = {
    "dc3c97e17592963677a4a1681f30c653": ("v2", "v2", False),
    "43797be674a37c1c83ee81081941ed0f": ("v2", "v3", False),
    "6642b37f3dbb1f76882b69937c95a5f3": ("v2", "v2", False),
    "4f26b9476d0c5033e04162c486074374": ("v2", "v4", False),
    "c7e9fce2223f3db685cdfa1e6368728a": ("v2", "v2Pro", False),
    "66b313e39455b57ab1b0bc0b239c9d0a": ("v2", "v2ProPlus", False),
}


def sniff_sovits_version(path: str) -> tuple[str, str, bool]:
    """(symbol_version, model_version, is_lora), as the reference's
    get_sovits_version_from_path_fast (process_ckpt.py:100): a published
    pretrained file by the md5 of its first 8 KB, else the two version
    bytes, else (a zip's "PK") by its size."""
    with open(path, "rb") as f:
        head8k = f.read(8192)
    h = hashlib.md5(head8k).hexdigest()
    if h in HASH_PRETRAINED:
        return HASH_PRETRAINED[h]
    head = head8k[:2]
    if head != b"PK":
        return HEAD2VERSION[head]
    size = os.path.getsize(path)
    if size < 82978 * 1024:
        return ("v1", "v1", False)
    if size < 700 * 1024 * 1024:
        return ("v2", "v2", False)
    return ("v2", "v3", False)


def merge_lora_state_dict(lora_sd: dict, base_sd: dict) -> dict:
    """A reference v3/v4 LoRA export merged onto the pretrained base's state
    dict -> a plain SynthesizerTrnV3 state dict (TTS.py:552-572: peft on
    the CFM's to_q/to_k/to_v/to_out.0 with lora_alpha == r, so the scale is
    1, then merge_and_unload). peft's key forms:
    `cfm.base_model.model.<p>.base_layer.weight` (a base weight the export
    carries) and `<p>.lora_A[.default].weight` / `<p>.lora_B[.default].weight`
    (W += B @ A, in float32)."""
    out = dict(base_sd)
    deltas: dict[str, dict] = {}
    for k, v in lora_sd.items():
        plain = k.replace("base_model.model.", "").replace(".base_layer.", ".")
        if ".lora_A." in k or ".lora_B." in k:
            which = "A" if ".lora_A." in k else "B"
            tgt = plain.split(f".lora_{which}.")[0] + ".weight"
            deltas.setdefault(tgt, {})[which] = v.float()
            continue
        out[plain] = v  # the non-frozen base parameters the export holds
    for tgt, ab in deltas.items():
        if "A" not in ab or "B" not in ab:
            raise ValueError(f"incomplete LoRA pair for {tgt}")
        if tgt not in out:
            raise KeyError(f"LoRA target {tgt} missing from base state_dict")
        out[tgt] = torch.as_tensor(out[tgt]).float() + ab["B"] @ ab["A"]
    return out
