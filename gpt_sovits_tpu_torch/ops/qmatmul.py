"""int8 DiT projections: K2, K3 and K4, the ports of the Pallas kernels
gpt_sovits_tpu/ops/pallas/qmatmul.py `qdense_int8`, `qkv_rope_int8` and
`qdense_out_int8`.

On CUDA tensors each wrapper launches the kernels of ``csrc/qmatmul.cu``
(``row_quant``, then the s8 GEMM as ``qdense`` or ``qkv_rope``; for K4
``row_quant_heads``, then ``qdense``; tiled as ``gemm_plan`` says; the note at the top of
that file says what bounds them); on CPU tensors it takes its plain PyTorch twin
(``qdense_int8_plain``, ``qkv_rope_int8_plain``, ``qdense_out_int8_plain``),
which is what the kernels are held against. There is no other route.

Layouts: x (B, T, K) (or (T, K) for qdense), int8 weights in PyTorch's
Linear layout (N, K) with (N,) f32 per-output-channel scales, f32 biases;
qkv_rope returns q, k, v as (B, H, T, dim_head), and qdense_out takes that
heads-in layout. The kernels take bf16 activations and f32 scales, biases,
AdaLN vectors, gates and masks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from gpt_sovits_tpu_torch.ops import build

INV127 = float(np.float32(1.0 / 127.0))
LN_EPS = 1e-6
GEMM_TILE_N = 128  # N must be a multiple of this (the wide GEMM tile)
GEMM_TILE_K = 64  # K must be a multiple of this (the TMA rows are 16-byte aligned; the last slot is zero-filled)
GEMM_TILE_M = 128  # output rows per GEMM block (csrc/qmatmul.cu GemmCfg::BM)
GEMM_TILES_N = (64, 128)  # the GEMM block widths the kernels are built for
SMS = 132  # streaming multiprocessors of the H100 SXM
MAX_K = 2048  # row_quant holds a row of at most this many values

# the kernels, in the order gsv_qmm_launch_counts reports their launches
KERNELS = ("row_quant", "qdense_int8", "qkv_rope_int8", "row_quant_heads", "qdense_out_int8")


def launch_counts() -> dict:
    """Launches of each kernel since the last reset, as the CUDA code counts
    them. All zero while the library is not loaded."""
    lib = build.loaded("qmatmul")
    if lib is None:
        return dict.fromkeys(KERNELS, 0)
    out = (ctypes.c_longlong * len(KERNELS))()
    lib.gsv_qmm_launch_counts(out)
    return dict(zip(KERNELS, out))


def reset_launch_counts() -> None:
    lib = build.loaded("qmatmul")
    if lib is not None:
        lib.gsv_qmm_reset_launch_counts()


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _quant_rows(x, ln_mod=None):
    """x (B, T, K) -> (int codes as f32 (B, T, K), scales (B, T, 1)), with the
    optional affine-free LayerNorm + AdaLN prologue, all in f32."""
    xf = x.float()
    if ln_mod is not None:
        sc, sh = ln_mod
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        xn = (xf - mu) * torch.rsqrt(var + LN_EPS)
        xf = xn * (1.0 + sc.float()[:, None]) + sh.float()[:, None]
    sx = torch.clamp_min(xf.abs().amax(-1, keepdim=True) * INV127, 1e-8)
    xq = torch.clamp(torch.round(xf * torch.reciprocal(sx)), -127, 127)
    return xq, sx


def _int_proj(xq, sx, w, sw, bias):
    """acc * sx * sw + b; float64 holds every s8 x s8 sum of K <= 2048 exactly."""
    acc = (xq.double() @ w.double().t()).float()
    return acc * sx * sw.float().reshape(-1) + bias.float().reshape(-1)


def _gelu_tanh(y):
    return 0.5 * y * (1.0 + torch.tanh(0.7978845608028654 * (y + 0.044715 * y * y * y)))


def qdense_int8_plain(x, wq, sw, bias, ln_mod=None, res_gate=None, mask=None, *, act=None):
    """y = (round(x / sx) @ wq^T) * sx * sw + b, with the optional glue:
    ln_mod=(scale (B,K), shift (B,K)) prologue, act="gelu" (tanh) epilogue,
    mask (B,T) pad-row zeroing, res_gate=(res (B,T,N), gate (B,N)):
    y = res + gate * y. Returns x.dtype."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    xq, sx = _quant_rows(x, ln_mod)
    y = _int_proj(xq, sx, wq, sw, bias)
    if act == "gelu":
        y = _gelu_tanh(y)
    elif act is not None:
        raise ValueError(f"act {act!r}: only 'gelu'")
    if mask is not None:
        y = torch.where(mask[..., None] > 0, y, torch.zeros_like(y))
    if res_gate is not None:
        res, gate = res_gate
        y = res.float() + gate.float()[:, None] * y
    y = y.to(x.dtype)
    return y[0] if squeeze else y


def rope_table(t_len: int, dim_head: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (T, dim_head/2) f32 of positions 0..T-1 (computed in float64
    as the JAX kernel's wrapper computes them)."""
    inv = 1.0 / (10000.0 ** (np.arange(0, dim_head, 2, dtype=np.float64) / dim_head))
    freqs = np.einsum("t,f->tf", np.arange(t_len), inv)
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device))


def rope_head0(y, cos, sin, dim_head: int):
    """Rotate interleaved pairs of the first dim_head channels of (B, T, N)
    only, in f32 (the reference's pre-split rotary quirk, dit.py:135)."""
    x_rot = y[..., :dim_head]
    even, odd = x_rot[..., 0::2], x_rot[..., 1::2]
    rot = torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1).reshape(x_rot.shape)
    return torch.cat([rot, y[..., dim_head:]], dim=-1)


def qkv_rope_int8_plain(x, wq, wk, wv, sq, sk, sv, bq, bk, bv, ln_mod=None, *, dim_head: int, q_scale: float = 1.0):
    """q, k, v (B, H, T, dim_head) in x.dtype: x quantized once (after the
    optional prologue), three W8A8 projections, rotary on head 0 of q and k,
    q times q_scale."""
    b, t, _ = x.shape
    xq, sx = _quant_rows(x, ln_mod)
    cos, sin = rope_table(t, dim_head, x.device)
    outs = []
    for i, (w, s, bias) in enumerate(((wq, sq, bq), (wk, sk, bk), (wv, sv, bv))):
        y = _int_proj(xq, sx, w, s, bias)
        if i < 2:
            y = rope_head0(y, cos, sin, dim_head)
        if i == 0 and q_scale != 1.0:
            y = y * q_scale
        n = y.shape[-1]
        outs.append(y.reshape(b, t, n // dim_head, dim_head).permute(0, 2, 1, 3).to(x.dtype).contiguous())
    return tuple(outs)


def qdense_out_int8_plain(attn, wq, sw, bias, res_gate_mask=None):
    """K4's function: attn (B, H, T, dh) with its heads merged to
    (B, T, H*dh), then qdense_int8_plain; res_gate_mask=(res (B,T,N),
    gate (B,N), mask (B,T) or None): y = res + gate * (mask ? y : 0).
    Returns attn.dtype (B, T, N)."""
    b, h, t, dh = attn.shape
    res_gate = mask = None
    if res_gate_mask is not None:
        res, gate, mask = res_gate_mask
        res_gate = (res, gate)
    merged = attn.permute(0, 2, 1, 3).reshape(b, t, h * dh)
    return qdense_int8_plain(merged, wq, sw, bias, res_gate=res_gate, mask=mask)


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensors launch the kernels, CPU tensors take the twin
# ---------------------------------------------------------------------------


def _lib():
    lib = build.load("qmatmul")
    if not getattr(lib, "_gsv_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gsv_row_quant.argtypes = [P, P, P, P, P, I, I, I, I, P]
        lib.gsv_qdense.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.gsv_qkv_rope.argtypes = [P] * 16 + [I, I, I, I, I, F, I, I, P]
        lib.gsv_row_quant_heads.argtypes = [P, P, P, I, I, I, I, P]
        lib.gsv_qdense_out.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        for fn in (lib.gsv_row_quant, lib.gsv_qdense, lib.gsv_qkv_rope, lib.gsv_row_quant_heads, lib.gsv_qdense_out):
            fn.restype = ctypes.c_int
        lib.gsv_qmm_launch_counts.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.gsv_qmm_launch_counts.restype = None
        lib.gsv_qmm_reset_launch_counts.argtypes = []
        lib.gsv_qmm_reset_launch_counts.restype = None
        lib._gsv_typed = True
    return lib


def check(name, t, dtype, shape, device, card: bool = True):
    """Raise unless t is a contiguous tensor of the given shape on the given
    device; for a launch (card) also of the given dtype and 16-byte aligned.
    The wrappers check the layout on every device, so the CPU tests catch a
    layout the kernels would refuse."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if card and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if card and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise before a launch that would cut a gradient: the kernels have no
    backward, and their output carries no grad_fn. A CPU tensor takes the
    differentiable twin instead, so training runs the plain composition on
    every device (the JAX package trains without its kernels too)."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; an input requires a gradient "
                           "(run the plain version, or call under torch.no_grad())")


def refuse_trace(name: str, t: torch.Tensor) -> None:
    """Raise before a launch that torch.export or torch.compile is tracing:
    a ctypes launch cannot be traced, and a fake tensor has no memory to
    launch on. One tensor tells: under torch.export every input is fake
    together. utils/export.py exports the plain compositions instead (the
    JAX exports trace no Pallas kernel either)."""
    if torch.compiler.is_compiling() or isinstance(t, FakeTensor):
        raise RuntimeError(f"{name}: the CUDA kernel cannot be traced by torch.export or torch.compile "
                           "(export the plain version: BigVGAN(use_kernel=False), the float DiT, the plain S1 step)")


def on_card(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the twin); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def gemm_plan(m: int, n: int, z: int = 1) -> tuple[int, int]:
    """(tile_n, grid_m) of the s8 GEMM for z (m, n) outputs of one launch
    (z = 3 for K3's q, k and v): blocks of GEMM_TILE_M rows (the last one
    ragged) by tile_n columns, launched as an (n / tile_n, grid_m, z) grid.
    128-column tiles where they alone give every SM a block, else 64-column
    ones (two fit an SM): at B = 1 (M = 1024, N = 1024) K2 launches 128
    blocks for the 132 SMs instead of 64, and K3 192 wide ones. The
    threshold is measured (chip_smoke.py gemm_tile_phase, PERF.md)."""
    grid_m = -(-m // GEMM_TILE_M)
    tile_n = 128 if grid_m * (n // 128) * z >= SMS else 64
    return tile_n, grid_m


def _check_gemm(k: int, n: int):
    if k % GEMM_TILE_K or k > MAX_K:
        raise ValueError(f"the int8 GEMM takes K a multiple of {GEMM_TILE_K} up to {MAX_K}, got {k}")
    if n % GEMM_TILE_N:
        raise ValueError(f"the int8 GEMM takes N a multiple of {GEMM_TILE_N}, got {n}")


def _check_ln(ln_mod, b, k, dev, card):
    if ln_mod is not None:
        check("ln_mod scale", ln_mod[0], torch.float32, (b, k), dev, card)
        check("ln_mod shift", ln_mod[1], torch.float32, (b, k), dev, card)


def _row_quant(x, ln_mod):
    """Launch row_quant: (B, T, K) bf16 -> int8 codes (B*T, K), scales (B*T,)."""
    b, t, k = x.shape
    dev = x.device
    xq = torch.empty((b * t, k), dtype=torch.int8, device=dev)
    sx = torch.empty((b * t,), dtype=torch.float32, device=dev)
    rc = _lib().gsv_row_quant(
        x.data_ptr(), ln_mod[0].data_ptr() if ln_mod is not None else None,
        ln_mod[1].data_ptr() if ln_mod is not None else None, xq.data_ptr(), sx.data_ptr(),
        b * t, k, t, int(ln_mod is not None), torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(rc, "row_quant")
    return xq, sx


def _gemm(xq, sx, wq, sw, bias, res, gate, mask, t: int, *, gelu: bool = False, heads_in: bool = False,
          tile_n: int | None = None):
    """Launch the qdense GEMM on row_quant's codes xq (M, K) and scales sx
    (M,): out (M / t, t, N) bf16. heads_in counts the launch as K4's
    (gsv_qdense_out, no gelu). tile_n overrides gemm_plan's width (a
    measurement's knob)."""
    m, k = xq.shape
    n = wq.shape[0]
    plan_n, grid_m = gemm_plan(m, n)
    tile_n = plan_n if tile_n is None else tile_n
    if tile_n not in GEMM_TILES_N:
        raise ValueError(f"qdense tiles are {GEMM_TILES_N} columns wide, got {tile_n}")
    out = torch.empty((m // t, t, n), dtype=torch.bfloat16, device=xq.device)
    ptrs = (xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(), bias.data_ptr(),
            res.data_ptr() if res is not None else None, gate.data_ptr() if gate is not None else None,
            mask.data_ptr() if mask is not None else None, out.data_ptr(), m, n, k, t)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    if heads_in:
        raise_on(_lib().gsv_qdense_out(*ptrs, tile_n, grid_m, stream), "qdense_out_int8")
    else:
        raise_on(_lib().gsv_qdense(*ptrs, int(gelu), tile_n, grid_m, stream), "qdense_int8")
    return out


def qdense_int8(x, wq, sw, bias, ln_mod=None, res_gate=None, mask=None, *, act=None):
    """K2. See qdense_int8_plain for the function; on CUDA: x bf16 (B, T, K)
    or (T, K), wq int8 (N, K), sw/bias f32 (N,), ln_mod f32 (B, K) each,
    res bf16 (B, T, N), gate f32 (B, N), mask f32 (B, T); returns bf16."""
    card = on_card(x)
    if card:
        refuse_trace("qdense_int8", x)
    if act not in (None, "gelu"):
        raise ValueError(f"act {act!r}: only 'gelu'")
    x3 = x[None] if x.ndim == 2 else x
    b, t, k = x3.shape
    n = wq.shape[0]
    dev = x.device
    _check_gemm(k, n)
    check("x", x3, torch.bfloat16, (b, t, k), dev, card)
    check("wq", wq, torch.int8, (n, k), dev, card)
    check("sw", sw, torch.float32, (n,), dev, card)
    check("bias", bias, torch.float32, (n,), dev, card)
    _check_ln(ln_mod, b, k, dev, card)
    res = gate = None
    if res_gate is not None:
        res, gate = res_gate
        check("res", res, torch.bfloat16, (b, t, n), dev, card)
        check("gate", gate, torch.float32, (b, n), dev, card)
    if mask is not None:
        check("mask", mask, torch.float32, (b, t), dev, card)
    if not card:
        return qdense_int8_plain(x, wq, sw, bias, ln_mod, res_gate, mask, act=act)
    refuse_grad("qdense_int8", x, wq, sw, bias, *(ln_mod or ()), *(res_gate or ()), mask)
    squeeze, x = x.ndim == 2, x3
    xq, sx = _row_quant(x, ln_mod)
    out = _gemm(xq, sx, wq, sw, bias, res, gate, mask, t, gelu=act == "gelu")
    return out[0] if squeeze else out


_ROPE: dict = {}


def _rope_cached(t_len: int, dim_head: int, device):
    key = (t_len, dim_head, device)
    if key not in _ROPE:
        _ROPE[key] = rope_table(t_len, dim_head, device)
    return _ROPE[key]


def _qkv_gemm(xq, sx, ws, ss, bs, b: int, t: int, dim_head: int, q_scale: float, tile_n: int | None = None):
    """Launch K3's GEMM on row_quant's codes xq (B*T, K) and scales sx:
    q, k, v bf16 (B, N/dim_head, T, dim_head). tile_n overrides gemm_plan's
    width (a measurement's knob)."""
    m = b * t
    n = ws[0].shape[0]
    dev = xq.device
    plan_n, grid_m = gemm_plan(m, n, 3)
    tile_n = plan_n if tile_n is None else tile_n
    if tile_n not in GEMM_TILES_N:
        raise ValueError(f"qkv_rope tiles are {GEMM_TILES_N} columns wide, got {tile_n}")
    cos, sin = _rope_cached(t, dim_head, dev)
    outs = tuple(torch.empty((b, n // dim_head, t, dim_head), dtype=torch.bfloat16, device=dev) for _ in range(3))
    rc = _lib().gsv_qkv_rope(
        xq.data_ptr(), sx.data_ptr(), *(w.data_ptr() for w in ws), *(s.data_ptr() for s in ss),
        *(v.data_ptr() for v in bs), cos.data_ptr(), sin.data_ptr(), *(o.data_ptr() for o in outs),
        m, n, xq.shape[1], t, dim_head, float(q_scale), tile_n, grid_m, torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(rc, "qkv_rope_int8")
    return outs


def qkv_rope_int8(x, wq, wk, wv, sq, sk, sv, bq, bk, bv, ln_mod=None, *, dim_head: int, q_scale: float = 1.0):
    """K3. See qkv_rope_int8_plain for the function; on CUDA: x bf16
    (B, T, K), three int8 (N, K) weights with f32 (N,) scales and biases,
    ln_mod f32 (B, K) each, dim_head a multiple of 8 (an epilogue thread's
    8 columns lie in one head); returns q, k, v bf16 (B, N/dim_head, T,
    dim_head)."""
    card = on_card(x)
    if card:
        refuse_trace("qkv_rope_int8", x)
    b, t, k = x.shape
    n = wq.shape[0]
    dev = x.device
    _check_gemm(k, n)
    if dim_head % 8 or n % dim_head:
        raise ValueError(f"dim_head {dim_head} must be a multiple of 8 and divide N={n}")
    check("x", x, torch.bfloat16, (b, t, k), dev, card)
    for nm, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        check(nm, w, torch.int8, (n, k), dev, card)
    for nm, v in (("sq", sq), ("sk", sk), ("sv", sv), ("bq", bq), ("bk", bk), ("bv", bv)):
        check(nm, v, torch.float32, (n,), dev, card)
    _check_ln(ln_mod, b, k, dev, card)
    if not card:
        return qkv_rope_int8_plain(x, wq, wk, wv, sq, sk, sv, bq, bk, bv, ln_mod, dim_head=dim_head, q_scale=q_scale)
    refuse_grad("qkv_rope_int8", x, wq, wk, wv, sq, sk, sv, bq, bk, bv, *(ln_mod or ()))
    xq, sx = _row_quant(x, ln_mod)
    return _qkv_gemm(xq, sx, (wq, wk, wv), (sq, sk, sv), (bq, bk, bv), b, t, dim_head, q_scale)


def qdense_out_int8(attn, wq, sw, bias, res_gate_mask=None):
    """K4. See qdense_out_int8_plain for the function; on CUDA: attn bf16
    (B, H, T, dh) with dh % 8 == 0, wq int8 (N, H*dh), sw/bias f32 (N,),
    res bf16 (B, T, N), gate f32 (B, N), mask f32 (B, T) or None; returns
    bf16 (B, T, N)."""
    card = on_card(attn)
    if card:
        refuse_trace("qdense_out_int8", attn)
    b, h, t, dh = attn.shape
    k = h * dh
    n = wq.shape[0]
    dev = attn.device
    _check_gemm(k, n)
    if dh % 8:
        raise ValueError(f"qdense_out_int8 takes dim_head a multiple of 8, got {dh}")
    check("attn", attn, torch.bfloat16, (b, h, t, dh), dev, card)
    check("wq", wq, torch.int8, (n, k), dev, card)
    check("sw", sw, torch.float32, (n,), dev, card)
    check("bias", bias, torch.float32, (n,), dev, card)
    res = gate = mask = None
    if res_gate_mask is not None:
        res, gate, mask = res_gate_mask
        check("res", res, torch.bfloat16, (b, t, n), dev, card)
        check("gate", gate, torch.float32, (b, n), dev, card)
        if mask is not None:
            check("mask", mask, torch.float32, (b, t), dev, card)
    if not card:
        return qdense_out_int8_plain(attn, wq, sw, bias, res_gate_mask)
    refuse_grad("qdense_out_int8", attn, wq, sw, bias, *(res_gate_mask or ()))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    xq = torch.empty((b * t, k), dtype=torch.int8, device=dev)
    sx = torch.empty((b * t,), dtype=torch.float32, device=dev)
    raise_on(lib.gsv_row_quant_heads(attn.data_ptr(), xq.data_ptr(), sx.data_ptr(), b * t, k, t, dh, stream),
             "row_quant_heads")
    return _gemm(xq, sx, wq, sw, bias, res, gate, mask, t, heads_in=True)
