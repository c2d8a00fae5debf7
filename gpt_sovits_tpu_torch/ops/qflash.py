"""One-shot-softmax attention with an int8 P@V: K5, the port of the Pallas
kernel gpt_sovits_tpu/ops/pallas/qflash.py `flash_attn_int8`.

On CUDA tensors `flash_attn_int8` launches the kernels of ``csrc/qflash.cu``
(``v_quant``, then ``flash_attn``; the note at the top of that file says what
bounds them); on CPU tensors it takes its plain twin
``flash_attn_int8_plain``, which is what the kernels are held against.

q, k, v (B, H, T, dim_head) -> (B, T, H * dim_head), heads merged; mask
(B, T), > 0 for real keys. Pad query rows give finite values that the
caller's next masked projection zeroes. Unlike the Pallas wrapper, any T is
taken (the TPU needed T to be a multiple of its query block).
"""

from __future__ import annotations

import ctypes

import torch

from gpt_sovits_tpu_torch.ops import build
from gpt_sovits_tpu_torch.ops.qmatmul import INV127, check, on_card, raise_on, refuse_grad, refuse_trace
from gpt_sovits_tpu_torch.utils.metrics import recorder

HEAD_DIM = 64  # the only head width the kernel takes
KEY_TILE = 128  # keys per tile (csrc/qflash.cu KB): V's int8 copy is padded to it

# the kernels, in the order gsv_qflash_launch_counts reports their launches
KERNELS = ("v_quant", "flash_attn_int8")
# while tracing is on, each launch is recorded under its device kernel's name
# (utils/metrics.py Recorder.launch)
_REC = recorder()
_K_V_QUANT, _K_FLASH = _REC.intern("v_quant_kernel"), _REC.intern("flash_attn_wgmma_kernel")


def launch_counts() -> dict:
    lib = build.loaded("qflash")
    if lib is None:
        return dict.fromkeys(KERNELS, 0)
    out = (ctypes.c_longlong * len(KERNELS))()
    lib.gsv_qflash_launch_counts(out)
    return dict(zip(KERNELS, out))


def reset_launch_counts() -> None:
    lib = build.loaded("qflash")
    if lib is not None:
        lib.gsv_qflash_reset_launch_counts()


def key_pad(t: int) -> int:
    """T rounded up to whole key tiles: the length of v8t's rows, which
    flash_attn's TMA reads a tile at a time (zeros past T)."""
    return -(-t // KEY_TILE) * KEY_TILE


def flash_attn_int8_plain(q, k, v, mask=None, *, sm_scale: float):
    """q scaled by sm_scale in q.dtype; QK^T in f32 from those values; -1e9
    on pad keys; e8 = round(exp(s - max) * 127); V quantized per (b, head,
    column) over all T rows; out = (e8 @ v8) * sv / sum(e8), in q.dtype."""
    b, h, t, dh = q.shape
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    if mask is not None:
        s = s + torch.where(mask > 0, 0.0, -1e9).float()[:, None, None, :]
    e8 = torch.round(torch.exp(s - s.amax(-1, keepdim=True)) * 127.0)
    vf = v.float()
    sv = torch.clamp_min(vf.abs().amax(2, keepdim=True) * INV127, 1e-8)  # (B, H, 1, dh)
    v8 = torch.clamp(torch.round(vf * torch.reciprocal(sv)), -127, 127)
    # float64 holds every sum of products of codes (T x 127 x 127) exactly
    o = torch.einsum("bhqk,bhkd->bhqd", e8.double(), v8.double()).float()
    r = e8.double().sum(-1, keepdim=True).float()
    out = o * sv * torch.reciprocal(r)
    return out.permute(0, 2, 1, 3).reshape(b, t, h * dh).to(q.dtype)


def _lib():
    lib = build.load("qflash")
    if not getattr(lib, "_gsv_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gsv_v_quant.argtypes = [P, P, P, I, I, I, P]
        lib.gsv_flash_attn.argtypes = [P, P, P, P, P, P, I, I, I, I, F, P]
        for fn in (lib.gsv_v_quant, lib.gsv_flash_attn):
            fn.restype = ctypes.c_int
        lib.gsv_qflash_launch_counts.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.gsv_qflash_launch_counts.restype = None
        lib.gsv_qflash_reset_launch_counts.argtypes = []
        lib.gsv_qflash_reset_launch_counts.restype = None
        lib._gsv_typed = True
    return lib


def flash_attn_int8(q, k, v, mask=None, *, sm_scale: float):
    """K5. On CUDA: q, k, v bf16 (B, H, T, 64), mask f32 (B, T) or None;
    returns bf16 (B, T, H*64)."""
    card = on_card(q)
    if card:
        refuse_trace("flash_attn_int8", q)
    b, h, t, dh = q.shape
    dev = q.device
    for nm, x in (("q", q), ("k", k), ("v", v)):
        check(nm, x, torch.bfloat16, (b, h, t, dh), dev, card)
    if mask is not None:
        check("mask", mask, torch.float32, (b, t), dev, card)
    if not card:
        return flash_attn_int8_plain(q, k, v, mask, sm_scale=sm_scale)
    refuse_grad("flash_attn_int8", q, k, v, mask)
    if dh != HEAD_DIM:
        raise ValueError(f"flash_attn_int8 takes dim_head {HEAD_DIM}, got {dh}")
    t_pad = key_pad(t)
    v8t = torch.empty((b, h, dh, t_pad), dtype=torch.int8, device=dev)
    sv = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    out = torch.empty((b, t, h * dh), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    _REC.launch(_K_V_QUANT)
    raise_on(lib.gsv_v_quant(v.data_ptr(), v8t.data_ptr(), sv.data_ptr(), b * h, t, t_pad, stream), "v_quant")
    _REC.launch(_K_FLASH)
    rc = lib.gsv_flash_attn(
        q.data_ptr(), k.data_ptr(), v8t.data_ptr(), sv.data_ptr(), mask.data_ptr() if mask is not None else None,
        out.data_ptr(), b, h, t, t_pad, float(sm_scale), stream,
    )
    raise_on(rc, "flash_attn_int8")
    return out
