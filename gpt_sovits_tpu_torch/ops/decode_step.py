"""S1 decode step: K1, the port of the Pallas kernel
gpt_sovits_tpu/ops/pallas/decode_step.py `fused_decode_step`.

One token step through all L post-LN layers for B <= 8 rows, with stacked
weights in bf16 or W8A8 int8 and a K||V cache in bf16 or int8. On CUDA
tensors one persistent kernel of ``csrc/decode_step.cu`` runs the whole
step in one launch (see the note at the top of that file for what bounds it
and how); on CPU tensors the step runs the plain PyTorch twins.
``fused_decode_step_plain`` runs the whole step on the twins on any device,
which is what the kernel is held against.

Layout (as in the JAX package, but for the weights): kv_cache (L, B, T, 2D)
with K in [0, D) and V in [D, 2D); kv_scales (L, B, 2, T) f32 in int8-KV
mode; mask (B, T) f32, 1 = attendable, EXCLUDING the slot being written (the
step attends to the new token's own K/V itself). ``write_idx`` is one slot
for every row (an int, as `generate` passes), or one slot a row (a (B,)
integer tensor or sequence, as continuous batching passes): row i writes its
new K/V at write_idx[i], and every row attends over [0, max(write_idx))
under its mask, as the JAX function does (decode_step.py:462-519). Stacked
weight matrices are
K-major, (L, Dout, Din) (PyTorch's Linear layout; the JAX package stacks
(L, Din, Dout)), each 16 rows in the kernel's mma fragment order
(to_fragment_order), so that a block of the kernel reads its output columns
as one contiguous block. The step updates kv_cache/kv_scales in place at
the rows' slots (the JAX function returns new arrays; in place saves a copy
of the cache per token) and returns them.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from gpt_sovits_tpu_torch.ops import build
from gpt_sovits_tpu_torch.ops.qmatmul import refuse_grad, refuse_trace

NEG = -1e30
# launch geometry, as csrc/decode_step.cu defines it
MAX_ROWS = 8
STEP_WARPS = 8  # warps of a block of the whole-step kernel, which takes a (row, head) (step::WARPS)
STEP_MAX_SPLITS = 128  # attention splits a (row, head) of the whole-step kernel (step::MAX_SPLITS)
STEP_DIMS = (512, 2048, 16)  # the (D, F, heads) the whole-step kernel is built for (S1Config)

# the kernel, as gsv_launch_counts reports its launches
KERNELS = ("fused_decode_step",)


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset, as the CUDA code
    counts them at each launch. All zero while the library is not loaded."""
    lib = build.loaded("decode_step")
    if lib is None:
        return dict.fromkeys(KERNELS, 0)
    out = (ctypes.c_longlong * len(KERNELS))()
    lib.gsv_launch_counts(out)
    return dict(zip(KERNELS, out))


def reset_launch_counts() -> None:
    lib = build.loaded("decode_step")
    if lib is not None:
        lib.gsv_reset_launch_counts()


# ---------------------------------------------------------------------------
# weight / cache preparation (ports of the JAX helpers)
# ---------------------------------------------------------------------------


def _quantize_cols(w: torch.Tensor):
    """(L, Din, Dout) f32 -> per-output-channel symmetric int8 + (L, 1, Dout)
    f32 scales (decode_step.py:526)."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=1, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


FRAG_ROWS = 16  # output columns a block of the whole-step kernel owns: the mma's m


def _fragment_dims(w: torch.Tensor):
    l, n, k = w.shape
    ks = 32 if w.dtype == torch.int8 else 16  # K of one mma.sync k-step
    if n % FRAG_ROWS or k % ks:
        raise ValueError(f"fragment order needs N % {FRAG_ROWS} == 0 and K % {ks} == 0, got {(n, k)}")
    return l, n, k, ks


def to_fragment_order(w: torch.Tensor) -> torch.Tensor:
    """(L, N, K) K-major matrices, each 16 rows reordered as the whole-step
    kernel's mma A fragments: for item i (rows 16 i..), k-step s (32 int8 or
    16 bf16 of K), lane 4 g + t and register j, the values of row
    16 i + g + 8 (j & 1) at k = s KS + (KS / 2)(j >> 1) + (KS / 8) t + e,
    e < KS / 8, are stored together, so a lane's four registers are 16
    contiguous bytes and an item is one contiguous block. Same shape."""
    l, n, k, ks = _fragment_dims(w)
    e = ks // 8
    # source (L, i, h, g, s, jh, t, e) -> (L, i, s, g, t, jh, h, e)
    return w.reshape(l, n // 16, 2, 8, k // ks, 2, 4, e).permute(0, 1, 4, 3, 6, 5, 2, 7).reshape(l, n, k).contiguous()


def from_fragment_order(w: torch.Tensor) -> torch.Tensor:
    """The inverse of to_fragment_order: plain (L, N, K) rows."""
    l, n, k, ks = _fragment_dims(w)
    e = ks // 8
    return w.reshape(l, n // 16, k // ks, 8, 4, 2, 2, e).permute(0, 1, 6, 3, 2, 5, 4, 7).reshape(l, n, k)


def stack_weights_from_params(state_dict: dict, num_layers: int, quant: str = "bf16") -> dict:
    """Stacked per-layer weights from a T2SDecoder state dict (reference
    names), the values decode_step.py:539 builds from the flax tree, with
    the matrices K-major, (L, Dout, Din), in the whole-step kernel's
    fragment order (to_fragment_order; from_fragment_order gives the plain
    rows): bf16, or int8 with (L, 1, Dout) per-output-channel scales;
    vectors (L, 1, N) f32."""
    if quant not in ("bf16", "int8"):
        raise ValueError(f"weight quant {quant!r}: expected 'bf16' or 'int8'")
    pre = [f"h.layers.{i}" for i in range(num_layers)]

    def mats(name):
        return torch.stack([state_dict[f"{p}.{name}"].float().t() for p in pre]).contiguous()

    def vecs(name):
        return torch.stack([state_dict[f"{p}.{name}"].float() for p in pre])[:, None].contiguous()

    out = {
        "bqkv": vecs("self_attn.in_proj_bias"), "bo": vecs("self_attn.out_proj.bias"),
        "n1s": vecs("norm1.weight"), "n1b": vecs("norm1.bias"),
        "n2s": vecs("norm2.weight"), "n2b": vecs("norm2.bias"),
        "b1": vecs("linear1.bias"), "b2": vecs("linear2.bias"),
    }
    for key, name in (("wqkv", "self_attn.in_proj_weight"), ("wo", "self_attn.out_proj.weight"),
                      ("fc1", "linear1.weight"), ("fc2", "linear2.weight")):
        w = mats(name)  # (L, Din, Dout), as the JAX package quantizes it
        if quant == "int8":
            w, out[f"{key}_s"] = _quantize_cols(w)
        else:
            w = w.to(torch.bfloat16)
        out[key] = to_fragment_order(w.transpose(1, 2).contiguous())
    return out


def quantize_kv_cache(kv_cache: torch.Tensor):
    """(L, B, T, 2D) float K||V -> (int8 cache, (L, B, 2, T) f32 scales),
    per-token symmetric for K and V separately (decode_step.py:334)."""
    d = kv_cache.shape[-1] // 2
    kf = kv_cache[..., :d].float()
    vf = kv_cache[..., d:].float()
    sk = torch.clamp_min(kf.abs().amax(-1) / 127.0, 1e-8)
    sv = torch.clamp_min(vf.abs().amax(-1) / 127.0, 1e-8)
    kq = torch.clamp(torch.round(kf / sk[..., None]), -127, 127)
    vq = torch.clamp(torch.round(vf / sv[..., None]), -127, 127)
    cache = torch.cat([kq, vq], dim=-1).to(torch.int8)
    return cache, torch.stack([sk, sv], dim=2)


# ---------------------------------------------------------------------------
# plain twins of the step's parts
# ---------------------------------------------------------------------------


def proj_plain(x, w, bias, w_scale=None, relu: bool = False):
    """y = x @ w + bias. bf16 weights: bf16 operands, f32 accumulation.
    int8 weights: W8A8 with a per-row dynamic activation scale."""
    if w.dtype == torch.int8:
        xs = torch.clamp_min(x.abs().amax(-1, keepdim=True), 1e-6) * (1.0 / 127.0)
        xq = torch.clamp(torch.round(x * torch.reciprocal(xs)), -127, 127)
        # float64 holds every s8 x s8 sum of these widths exactly
        acc = (xq.double() @ w.double()).float()
        y = acc * xs * w_scale.reshape(1, -1)
    else:
        y = x.to(torch.bfloat16).float() @ w.float()
    y = y + bias.reshape(1, -1)
    return torch.relu(y) if relu else y


def decode_attn_plain(qkv, kv, kv_scales, mask, n_valid: int, num_heads: int):
    """Attention of each row's new query over the live prefix [0, n_valid)
    of one layer's cache (B, T, 2D), masked by mask (B, T), plus its own
    fresh K/V. qkv (B, 3D) f32 -> context (B, D) f32."""
    b, d3 = qkv.shape
    d = d3 // 3
    h = num_heads
    dh = d // h
    scale = float(1.0 / np.sqrt(dh))
    q = (qkv[:, :d] * scale).reshape(b, h, dh)
    k_new = qkv[:, d : 2 * d].reshape(b, h, dh)
    v_new = qkv[:, 2 * d :].reshape(b, h, dh)
    live = kv[:, :n_valid]
    keys = live[..., :d].reshape(b, n_valid, h, dh)
    vals = live[..., d:].reshape(b, n_valid, h, dh)
    attendable = (mask[:, :n_valid] > 0)[:, None, :]
    int8 = kv.dtype == torch.int8
    if int8:
        qs = torch.clamp_min(q.abs().amax(-1), 1e-9) * (1.0 / 127.0)  # (B, H)
        qi = torch.clamp(torch.round(q / qs[..., None]), -127, 127)
        sc = torch.einsum("bhd,bthd->bht", qi.double(), keys.double()).float()
        sc = sc * (qs[..., None] * kv_scales[:, 0, None, :n_valid])
    else:
        sc = torch.einsum("bhd,bthd->bht", q.to(torch.bfloat16).float(), keys.float())
    sc = torch.where(attendable, sc, torch.full_like(sc, NEG))
    if n_valid > 0:
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        s = p.sum(-1)
        if int8:
            pv = p * kv_scales[:, 1, None, :n_valid]
            ps = torch.clamp_min(pv.amax(-1), 1e-9) * (1.0 / 127.0)
            pq = torch.clamp(torch.round(pv / ps[..., None]), -127, 127)
            ctx = torch.einsum("bht,bthd->bhd", pq.double(), vals.double()).float() * ps[..., None]
        else:
            ctx = torch.einsum("bht,bthd->bhd", p.to(torch.bfloat16).float(), vals.float())
    else:
        m = torch.full((b, h), NEG, device=qkv.device)
        s = torch.zeros((b, h), device=qkv.device)
        ctx = torch.zeros((b, h, dh), device=qkv.device)
    sc_self = (q * k_new).sum(-1)
    m_new = torch.maximum(m, sc_self)
    alpha = torch.exp(m - m_new)
    p_self = torch.exp(sc_self - m_new)
    s_fin = s * alpha + p_self
    ctx = (ctx * alpha[..., None] + p_self[..., None] * v_new) / s_fin[..., None]
    return ctx.reshape(b, d)


def add_layernorm_plain(x, y, scale, bias):
    """LN(x + y) * scale + bias over the last axis, eps 1e-5."""
    xa = x + y
    mu = xa.mean(-1, keepdim=True)
    var = ((xa - mu) ** 2).mean(-1, keepdim=True)
    return (xa - mu) * torch.rsqrt(var + 1e-5) * scale.reshape(1, -1) + bias.reshape(1, -1)


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensors launch the kernel, CPU tensors take the twin
# ---------------------------------------------------------------------------


def _lib():
    lib = build.load("decode_step")
    if not getattr(lib, "_gsv_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        PP = ctypes.POINTER(P)
        lib.gsv_decode_step.argtypes = [P, P, PP, PP, PP, P, P, P, P, P, P, P, P, P, F,
                                        I, I, I, ctypes.POINTER(I), I, I, I, I, P]
        lib.gsv_decode_step.restype = ctypes.c_int
        lib.gsv_launch_counts.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.gsv_launch_counts.restype = None
        lib.gsv_reset_launch_counts.argtypes = []
        lib.gsv_reset_launch_counts.restype = None
        lib._gsv_typed = True
    return lib


def _check(name, t, dtype, shape=None, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


COOPERATIVE_TOO_LARGE = 720  # cudaErrorCooperativeLaunchTooLarge


def _raise(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _route(t):
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _attn_scale(d: int, num_heads: int) -> float:
    return float(1.0 / np.sqrt(d // num_heads))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _slots(write_idx, b: int, t: int) -> list[int]:
    """write_idx as one slot a row: an int (or a 0-d tensor) is every row's
    slot, a (B,) integer tensor or sequence gives row i write_idx[i]. A
    tensor is read to the host, once: on the card that is one sync a step,
    of B <= 8 values, which size the attention's splits (step_splits).
    Refuses a non-integer type, another shape and a slot outside [0, T)."""
    if isinstance(write_idx, torch.Tensor):
        if write_idx.dtype.is_floating_point or write_idx.dtype.is_complex or write_idx.dtype == torch.bool:
            raise TypeError(f"write_idx: dtype {write_idx.dtype}, expected an integer type")
        write_idx = write_idx.tolist()
    slots = np.asarray(write_idx)
    if slots.dtype.kind not in "iu":
        raise TypeError(f"write_idx: {write_idx!r}, expected integers")
    if slots.ndim == 0:
        slots = np.full(b, slots)
    elif slots.shape != (b,):
        raise ValueError(f"write_idx: shape {slots.shape}, expected () or ({b},)")
    if slots.min() < 0 or slots.max() >= t:
        raise ValueError(f"write_idx {slots.tolist()} outside the cache [0, {t})")
    return [int(v) for v in slots]


def _check_step(x, weights, kv_cache, mask, write_idx, kv_scales) -> list[int]:
    """Refuses what the step cannot take, before any work; returns the
    rows' slots (_slots)."""
    n_layers, b, t, d2 = kv_cache.shape
    d = d2 // 2
    if kv_cache.dtype == torch.int8 and kv_scales is None:
        raise ValueError("int8 kv_cache requires kv_scales (L,B,2,T)")
    if x.shape != (b, d):
        raise ValueError(f"x: shape {tuple(x.shape)}, expected {(b, d)}")
    return _slots(write_idx, b, t)


def _write_new_kv(kv_cache, kv_scales, kv_new, slots):
    """The new token's K||V (L, B, 2D) bf16 into the cache, row i at
    slots[i], quantized per token in int8-KV mode (the TPU wrapper did this
    in XLA too, decode_step.py:487-520)."""
    if kv_cache.dtype == torch.int8:
        d = kv_new.shape[-1] // 2
        kf = kv_new[..., :d].float()
        vf = kv_new[..., d:].float()
        sk = torch.clamp_min(kf.abs().amax(-1) / 127.0, 1e-8)  # (L, B)
        sv = torch.clamp_min(vf.abs().amax(-1) / 127.0, 1e-8)
        kq = torch.clamp(torch.round(kf / sk[..., None]), -127, 127)
        vq = torch.clamp(torch.round(vf / sv[..., None]), -127, 127)
        kv_new = torch.cat([kq, vq], dim=-1)
        new_scales = torch.stack([sk, sv], dim=2)  # (L, B, 2)
    for row, slot in enumerate(slots):
        kv_cache[:, row, slot] = kv_new[:, row].to(kv_cache.dtype)
        if kv_cache.dtype == torch.int8:
            kv_scales[:, row, :, slot] = new_scales[:, row]
    return kv_cache, kv_scales if kv_cache.dtype == torch.int8 else None


def _result(x, kv_cache, kv_scales):
    return (x, kv_cache, kv_scales) if kv_cache.dtype == torch.int8 else (x, kv_cache)


def _step_plain(x, weights, kv_cache, mask, write_idx, kv_scales, num_heads):
    slots = _check_step(x, weights, kv_cache, mask, write_idx, kv_scales)
    n_layers, b, _, d2 = kv_cache.shape
    d = d2 // 2
    int8_kv = kv_cache.dtype == torch.int8
    quant = weights["wqkv"].dtype == torch.int8
    sc = (lambda k, i: weights[f"{k}_s"][i]) if quant else (lambda k, i: None)
    kv_new = torch.empty((n_layers, b, d2), dtype=torch.bfloat16, device=x.device)
    plain = {k: from_fragment_order(weights[k]) for k in MATS}
    w = lambda k, i: plain[k][i].t()  # noqa: E731  (Din, Dout)
    for i in range(n_layers):
        qkv = proj_plain(x, w("wqkv", i), weights["bqkv"][i], sc("wqkv", i))
        kv_new[i] = qkv[:, d:]
        ctx = decode_attn_plain(qkv, kv_cache[i], kv_scales[i] if int8_kv else None, mask, max(slots), num_heads)
        a = proj_plain(ctx, w("wo", i), weights["bo"][i], sc("wo", i))
        xn = add_layernorm_plain(x, a, weights["n1s"][i], weights["n1b"][i])
        hdn = proj_plain(xn, w("fc1", i), weights["b1"][i], sc("fc1", i), relu=True)
        y2 = proj_plain(hdn, w("fc2", i), weights["b2"][i], sc("fc2", i))
        x = add_layernorm_plain(xn, y2, weights["n2s"][i], weights["n2b"][i])
    # the new token's K/V go into the cache after all layers read it
    return _result(x, *_write_new_kv(kv_cache, kv_scales, kv_new, slots))


MATS = ("wqkv", "wo", "fc1", "fc2")  # the order gsv_decode_step takes them in
VECS = ("bqkv", "bo", "n1s", "n1b", "n2s", "n2b", "b1", "b2")

_SYNC: dict = {}


def _sync(device, stream: int) -> torch.Tensor:
    """The whole-step kernel's grid barrier count for one stream: zeroed
    once; each launch grows it by a multiple of the grid."""
    key = (device, stream)
    if key not in _SYNC:
        _SYNC[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _SYNC[key]


def step_splits(n_valid: int, kv_int8: bool) -> tuple[int, int]:
    """(slot_r, n_split) of the whole-step kernel's attention: a block takes
    a (row, head) and cuts the sweep [0, n_valid) (n_valid: the largest of
    the rows' write slots) into n_split
    splits of 32 x slot_r cache slots (a warp a split, slot_r slots a lane),
    at least one. slot_r is the smallest of 1, 2 (and 4 with int8 KV) that
    gives each warp of the block at most one split, or the largest."""
    choices = (1, 2, 4) if kv_int8 else (1, 2)
    for r in choices:
        n_split = max(1, -(-n_valid // (32 * r)))
        if n_split <= STEP_WARPS:
            break
    if n_split > STEP_MAX_SPLITS:
        raise ValueError(f"the step kernel attends to at most {STEP_MAX_SPLITS * 32 * r} cache slots, got {n_valid}")
    return r, n_split


def step_plan(n_valid: int, kv_int8: bool, plan_sweep=None) -> tuple[int, int]:
    """(slot_r, n_split) of a step whose sweep is n_valid: slot_r is
    step_splits' choice for plan_sweep (default n_valid), n_split the splits
    of 32 x slot_r slots that cover n_valid. The kernel adds a split's
    partials in split order and a split of masked slots adds exact zeros,
    so with slot_r fixed a row's result does not depend on the other rows'
    slots: a continuous-batching pool passes its longest sweep as
    plan_sweep."""
    if plan_sweep is None or plan_sweep < n_valid:
        plan_sweep = n_valid
    slot_r, _ = step_splits(plan_sweep, kv_int8)
    return slot_r, max(1, -(-n_valid // (32 * slot_r)))


def _check_step_dims(d: int, f: int, num_heads: int):
    if (d, f, num_heads) != STEP_DIMS:
        raise ValueError(f"the step kernel is built for (D, F, heads) = {STEP_DIMS}, got {(d, f, num_heads)}")


def check_step_request(device, d: int, f: int, num_heads: int, n_valid: int, kv_int8: bool):
    """Refuses, before a request does any work, what the step kernel cannot
    run: widths other than STEP_DIMS on a card (the CPU twins take any), and
    on every device a sweep (the last step's largest write slot, n_valid)
    longer than the kernel's attention splits reach (step_splits), so that
    the CPU refuses what the card would."""
    if torch.device(device).type == "cuda":
        _check_step_dims(d, f, num_heads)
    step_splits(n_valid, kv_int8)


def _step_cuda(x, weights, kv_cache, mask, write_idx, kv_scales, num_heads, plan_sweep=None):
    """The whole step in one launch of the persistent kernel
    (gsv_decode_step), which also writes the new token's K/V into the cache."""
    slots = _check_step(x, weights, kv_cache, mask, write_idx, kv_scales)
    n_layers, b, t, d2 = kv_cache.shape
    d = d2 // 2
    dev = x.device
    quant = weights["wqkv"].dtype == torch.int8
    int8_kv = kv_cache.dtype == torch.int8
    f = weights["fc1"].shape[1]
    _check_step_dims(d, f, num_heads)
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"the step takes 1..{MAX_ROWS} rows, got {b}")
    dims = dict(zip(MATS, ((3 * d, d), (d, d), (f, d), (d, f))))  # (N, K)
    widths = dict(zip(VECS, (3 * d, d, d, d, d, d, f, d)))
    _check("x", x, torch.float32, (b, d), dev)
    _check("kv_cache", kv_cache, (torch.bfloat16, torch.int8), None, dev)
    _check("mask", mask, torch.float32, (b, t), dev)
    if int8_kv:
        _check("kv_scales", kv_scales, torch.float32, (n_layers, b, 2, t), dev)
    for key, (k_out, k_in) in dims.items():
        _check(key, weights[key], torch.int8 if quant else torch.bfloat16, (n_layers, k_out, k_in), dev)
        if quant:
            _check(f"{key}_s", weights[f"{key}_s"], torch.float32, (n_layers, 1, k_out), dev)
    for key, n in widths.items():
        _check(key, weights[key], torch.float32, (n_layers, 1, n), dev)

    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.empty((b, d), **f32)
    qkv = torch.empty((b, 3 * d), **f32)
    ctx, attn, y2 = (torch.empty((b, d), **f32) for _ in range(3))
    hdn = torch.empty((b, f), **f32)
    slot_r, splits = step_plan(max(slots), int8_kv, plan_sweep)
    ptrs = lambda keys: (ctypes.c_void_p * len(keys))(*(weights[k].data_ptr() for k in keys))  # noqa: E731
    stream = _stream(x)
    rc = _lib().gsv_decode_step(
        x.data_ptr(), h.data_ptr(), ptrs(MATS), ptrs([f"{k}_s" for k in MATS]) if quant else None, ptrs(VECS),
        kv_cache.data_ptr(), kv_scales.data_ptr() if int8_kv else None, mask.data_ptr(),
        *(z.data_ptr() for z in (qkv, ctx, attn, hdn, y2)), _sync(dev, stream).data_ptr(),
        _attn_scale(d, num_heads), n_layers, b, t, (ctypes.c_int * b)(*slots), splits, slot_r, int(quant),
        int(int8_kv), stream,
    )
    if rc == COOPERATIVE_TOO_LARGE:
        raise RuntimeError("the step kernel needs its 128 blocks resident at once, and this card holds fewer")
    _raise(rc, "decode_step")
    return _result(h, kv_cache, kv_scales)


def fused_decode_step(x, weights, kv_cache, mask, write_idx, kv_scales=None, *, num_heads: int = 16,
                      plan_sweep=None):
    """Returns (hidden (B, D) f32, kv_cache) -- plus kv_scales in int8-KV
    mode -- with row i's new K||V written at its slot: write_idx, an int for
    every row or a (B,) integer tensor or sequence (a tensor on the card is
    read to the host once, to size the attention's splits; a list is not).
    Weights as built by `stack_weights_from_params`. plan_sweep: the sweep
    the kernel's split plan is chosen for (step_plan); the twins have no
    splits. CUDA tensors run the whole-step kernel; CPU tensors run the
    plain twins."""
    if _route(x):
        refuse_trace("fused_decode_step", x)
        refuse_grad("fused_decode_step", x, *weights.values(), kv_cache, mask, kv_scales)
        return _step_cuda(x, weights, kv_cache, mask, write_idx, kv_scales, num_heads, plan_sweep)
    return _step_plain(x, weights, kv_cache, mask, write_idx, kv_scales, num_heads)


def fused_decode_step_plain(x, weights, kv_cache, mask, write_idx, kv_scales=None, *, num_heads: int = 16):
    """The same function on the plain twins, on any device."""
    return _step_plain(x, weights, kv_cache, mask, write_idx, kv_scales, num_heads)


def step_bytes(weights: dict, kv_cache: torch.Tensor, n_valid: int) -> int:
    """Bytes the step must move at least: every weight once, the live KV
    prefix (and its scales) once, the new K/V written once."""
    wb = sum(v.numel() * v.element_size() for v in weights.values())
    n_layers, b, _, d2 = kv_cache.shape
    kvb = n_layers * b * (n_valid + 1) * d2 * kv_cache.element_size()
    if kv_cache.dtype == torch.int8:
        kvb += n_layers * b * 2 * (n_valid + 1) * 4
    return wb + kvb + math.prod((b, d2 // 2)) * 4 * 2
