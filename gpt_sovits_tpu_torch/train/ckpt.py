"""Checkpoint I/O (port of gpt_sovits_tpu/train/ckpt.py and the writers of
gpt_sovits_tpu/utils/checkpoint_compat.py).

Two tiers, as in the reference (SURVEY.md §5):
  * FULL training checkpoints: one `torch.save` file `{ckpt_dir}/state_{step}`
    holding the step, the epoch, the models', optimizers' and schedules'
    state and any EMA state; `latest_checkpoint` finds the newest for
    auto-resume. This is the port's own format (the JAX package writes
    orbax directories under the same names).
  * DISTRIBUTION exports: the reference's fp16 `{weight, config, info}`
    container (process_ckpt.savee, with the version-byte header of
    v2Pro `05` / v2ProPlus `06`, v3 `03`, v4 `04`), S2 without `enc_q.*` and
    with the decoder's and flows' weight norm split into `weight_g`/
    `weight_v` as the reference modules store it; and an `.npz` of the same
    fp16 tensors under the same names with a JSON `__meta__` (config, info).
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Optional

import numpy as np
import torch


def save_checkpoint(state: dict, ckpt_dir: str, step: int, prefix: str = "state") -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"{prefix}_{step}"))
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)  # a cut-off write leaves no state_* file
    return path


def latest_checkpoint(ckpt_dir: str, prefix: str = "state") -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(rf"{prefix}_(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), os.path.join(ckpt_dir, name)
    return best


def load_checkpoint(path: str, map_location="cpu") -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


# ---------------------------------------------------------------------------
# reference-format exports
# ---------------------------------------------------------------------------

VERSION_BYTES = {"v3": b"03", "v4": b"04", "v2Pro": b"05", "v2ProPlus": b"06"}

# the S2 weights the reference modules hold under weight norm
# (checkpoint_compat.py `s2_params_to_torch`): the decoder's upsamplers and
# resblocks, and every WN stack's cond/in/res_skip layers
_S2_WEIGHT_NORM = re.compile(
    r"dec\.ups\.\d+\.weight|dec\.resblocks\.\d+\.convs[12]\.\d+\.weight"
    r"|.*\.enc\.(cond_layer|in_layers\.\d+|res_skip_layers\.\d+)\.weight"
)


def s2_reference_state(state_dict: dict) -> dict:
    """The port's S2 or v3/v4 state dict -> the reference checkpoint's
    tensors: `enc_q.*` dropped (process_ckpt.savee), weight norm split as
    g = ||w|| over every dim but 0, v = w, computed in float32 numpy as the
    JAX exporter does (S2: the decoder, the flows' and enc_q's WN stacks;
    v3/v4: wns1's WN stack, as checkpoint_compat.py `s2v3_params_to_torch`)."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("enc_q."):
            continue
        if _S2_WEIGHT_NORM.fullmatch(k):
            w = v.detach().float().cpu().numpy()
            g = np.sqrt((w**2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
            out[k[: -len("weight")] + "weight_g"] = torch.from_numpy(g)
            out[k[: -len("weight")] + "weight_v"] = torch.from_numpy(w.copy())
        else:
            out[k] = v.detach().float().cpu()
    return out


def save_reference_pth(state_dict: dict, path: str, *, model_version: str = "v2", config=None,
                       info: str = "") -> str:
    """The reference's distribution checkpoint ({weight, config, info}, fp16;
    process_ckpt.savee/my_save2): the version bytes replace the zip's "PK"
    for v2Pro/v2ProPlus/v3/v4."""
    opt = {"weight": {k: v.detach().cpu().half() for k, v in state_dict.items()}, "config": config or {},
           "info": info}
    head = VERSION_BYTES.get(model_version)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if head is None:
        torch.save(opt, path)
    else:
        bio = io.BytesIO()
        torch.save(opt, bio)
        with open(path, "wb") as f:
            f.write(head + bio.getvalue()[2:])
    return path


def load_torch_checkpoint(path: str) -> dict:
    """torch.load of a reference checkpoint, version-byte header or not
    (process_ckpt.load_sovits_new). Not weights-only: the reference's own
    files pickle its trainer's HParams as `config`."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"PK":
        data = b"PK" + data[2:]
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=False)


def export_weights(state_dict: dict, path: str, *, config: dict | None = None, info: str = "") -> str:
    """An `.npz` of fp16 arrays under the reference names (float arrays;
    others as they are) with `__meta__` = JSON {config, info}."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {}
    for k, v in state_dict.items():
        a = v.detach().cpu().numpy()
        flat[k] = a.astype(np.float16) if a.dtype == np.float32 else a
    np.savez(path, __meta__=json.dumps({"config": config or {}, "info": info}), **flat)
    return path
