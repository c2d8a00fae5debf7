"""Anti-aliased snakeβ activation: K6, the port of the Pallas kernels
gpt_sovits_tpu/ops/pallas/snake_aa.py `snake_aa_fused` (K6) and
`snake_aa_folded` (K7, the same function on the TPU's lane-folded layout).

BigVGAN's `Activation1d` (reference alias_free_activation/torch/act.py):
x2 kaiser-sinc upsample over replicate-padded x, snakeβ
x + sin²(a·x) / (b + 1e-9), x2 downsample over the replicate-padded snaked
stream. On CUDA tensors `snake_aa` launches the kernel of
``csrc/snake_aa.cu`` (the note at the top of that file says what bounds it);
on CPU tensors it takes its plain twin `snake_aa_plain`, the three-step
composition in f32, which is what the kernel is held against. There is no
other route. What the kernel computes besides the function is here, so the
CPU tests reach it: its tile plan (`snake_plan`, `lane_chunks`) and the
constants of its own sin² (`sin2_coefficients`, `pi_parts`).

Layout: PyTorch's conv layout x (B, C, T), bf16 or f32, with per-channel
alpha and beta (C,) f32; the result has x's shape and dtype, computed in
f32. The resampling filters (`kaiser_sinc_filter1d`, `upsample1d`,
`downsample1d`) are this package's copies of gpt_sovits_tpu/models/
bigvgan.py's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gpt_sovits_tpu_torch import at_least_f32
from gpt_sovits_tpu_torch.ops import build
from gpt_sovits_tpu_torch.ops.qmatmul import check, on_card, raise_on, refuse_grad, refuse_trace

TAPS = 12  # filter taps of the x2 resampling (csrc/snake_aa.cu TAPS)
KERNELS = ("snake_aa",)
# the kernel's geometry (csrc/snake_aa.cu R, THREADS): a thread owns a chunk
# of OUTPUTS consecutive outputs of one row
OUTPUTS = 8
THREADS = 256
TILE_CHUNKS = 30  # chunks a warp stores: lanes 1..30; lanes 0 and 31 are its halo


def launch_counts() -> dict:
    """Launches since the last reset, as the CUDA code counts them. Zero
    while the library is not loaded."""
    lib = build.loaded("snake_aa")
    if lib is None:
        return dict.fromkeys(KERNELS, 0)
    out = (ctypes.c_longlong * len(KERNELS))()
    lib.gsv_snake_launch_counts(out)
    return dict(zip(KERNELS, out))


def reset_launch_counts() -> None:
    lib = build.loaded("snake_aa")
    if lib is not None:
        lib.gsv_snake_reset_launch_counts()


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass (reference alias_free_activation/torch/
    filter.py:33), f32."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * np.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = np.arange(-half_size, half_size) + 0.5 if even else np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


def _taps(ratio: int, like: torch.Tensor):
    ks = int(6 * ratio // 2) * 2
    filt = torch.from_numpy(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, ks)).to(like.device, like.dtype)
    return ks, filt.view(1, 1, ks).expand(like.shape[1], 1, ks)


def upsample1d(x: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Anti-aliased x ratio upsample of (B, C, T) (reference resample.py:10-30)."""
    ks, w = _taps(ratio, x)
    pad = ks // ratio - 1
    pad_left = pad * ratio + (ks - ratio) // 2
    pad_right = pad * ratio + (ks - ratio + 1) // 2
    y = ratio * F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), w, stride=ratio, groups=x.shape[1])
    return y[..., pad_left : y.shape[-1] - pad_right]


def downsample1d(x: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Anti-aliased / ratio downsample of (B, C, T) (reference resample.py:33-46)."""
    ks, w = _taps(ratio, x)
    pad_left, pad_right = ks // 2 - int(ks % 2 == 0), ks // 2
    return F.conv1d(F.pad(x, (pad_left, pad_right), mode="replicate"), w, stride=ratio, groups=x.shape[1])


def snake_beta(x, alpha, beta, logscale: bool = True):
    """x + sin²(a·x) / (b + 1e-9) on (B, C, T), per-channel a, b
    (reference activations.py:63-121)."""
    a = torch.exp(alpha) if logscale else alpha
    b = torch.exp(beta) if logscale else beta
    return x + (1.0 / (b[:, None] + 1e-9)) * torch.sin(x * a[:, None]) ** 2


def snake_aa_plain(x, alpha, beta, *, logscale: bool = True):
    """upsample1d -> snake_beta -> downsample1d in f32 (f64 stays f64);
    returns x.dtype."""
    h = snake_beta(upsample1d(at_least_f32(x)), at_least_f32(alpha), at_least_f32(beta), logscale)
    return downsample1d(h).to(x.dtype)


# ---------------------------------------------------------------------------
# the kernel's sine: sin^2(z) by its own range reduction and polynomial
# ---------------------------------------------------------------------------

SIN2_TERMS = 8  # coefficients of P (csrc/snake_aa.cu POLY)
SIN2_R = 1.6  # P is fitted on |r| <= SIN2_R: pi / 2 and the rounding of k = rint(z / pi) up to SIN2_ZMAX
SIN2_ZMAX = 1e5  # the kernel takes sinf beyond |z| = SIN2_ZMAX
SIN2_MAX_ABS_ERR = 2.5e-7  # of the kernel's float32 sin^2 against float64, |z| <= SIN2_ZMAX
INV_PI = np.float32(1.0 / np.pi)


def pi_parts() -> np.ndarray:
    """pi as three float32 parts, each the float32 of what the ones before
    leave (Cody-Waite): with FMAs, z - k p0 is exact and the reduction
    r = z - k pi keeps float32's relative precision for |z| <= SIN2_ZMAX."""
    p0 = np.float32(np.pi)
    p1 = np.float32(np.pi - np.float64(p0))
    p2 = np.float32(np.pi - np.float64(p0) - np.float64(p1))
    return np.array([p0, p1, p2], np.float32)


@functools.lru_cache(maxsize=1)
def sin2_coefficients() -> np.ndarray:
    """float32 c with sin^2(r) ~ r^2 (c[0] + c[1] r^2 + ... ) on |r| <=
    SIN2_R: least squares, in float64, of the relative error of
    P(w) = sin^2(sqrt w) / w at 4000 Chebyshev nodes of r."""
    r = np.abs(np.cos(np.linspace(0.0, np.pi, 4001)) * SIN2_R)
    r = r[r > 1e-6]
    w = r * r
    f = np.sin(r) ** 2 / w
    basis = np.vander(w, SIN2_TERMS, increasing=True) / f[:, None]
    return np.linalg.lstsq(basis, np.ones_like(w), rcond=None)[0].astype(np.float32)


# ---------------------------------------------------------------------------
# the tile plan: which thread computes and stores which outputs
# ---------------------------------------------------------------------------


class SnakePlan(NamedTuple):
    grid: int  # blocks: rows x tiles
    tiles: int  # blocks a row
    threads: int  # threads a block
    outputs: int  # outputs a thread: one chunk
    chunks_a_tile: int  # chunks a block stores
    vec: int  # elements of a 16-byte word


def _row_start(row: int, t: int, vec: int) -> int:
    """h0 <= 0: the first position of the row's chunk 0, which ends at the
    row's first 16-byte boundary (`head` elements in), or 0 when the row
    starts on one."""
    head = (-(row * t)) % vec
    return head - OUTPUTS if head else 0


def snake_plan(rows: int, t: int, element_size: int) -> SnakePlan:
    """The launch of csrc/snake_aa.cu for `rows` rows of t samples, 16-byte
    aligned at row 0. A row is cut into chunks of OUTPUTS positions starting
    at its h0 (_row_start), so every chunk that lies inside the row starts
    on a 16-byte boundary and takes 16-byte loads and stores; the chunk that
    holds the row's first `head` positions and the last, partial one take
    clamped scalar reads and store only their positions inside the row (the
    scalar path). A warp stores TILE_CHUNKS consecutive chunks, one a lane,
    and its first and last lanes compute the chunk on either side for their
    neighbours and store nothing (lane_chunks lists them); a block of
    THREADS threads is THREADS / 32 such warps in a row, and a row takes
    `tiles` blocks, as many as its longest-chunked variant of h0 needs."""
    if rows < 1 or t < 1:
        raise ValueError(f"snake_plan: rows {rows}, T {t}")
    vec = 16 // element_size
    per_tile = THREADS // 32 * TILE_CHUNKS
    chunks = max(-(-(t - _row_start(r, t, vec)) // OUTPUTS) for r in range(min(rows, vec)))
    tiles = -(-chunks // per_tile)
    return SnakePlan(rows * tiles, tiles, THREADS, OUTPUTS, per_tile, vec)


def lane_chunks(plan: SnakePlan, t: int, row: int) -> list[tuple[int, bool, bool]]:
    """(first position c, stores, vector) of every thread of the row's
    blocks, as csrc/snake_aa.cu computes them: it stores
    positions [c, c + OUTPUTS) inside [0, t) where `stores`, with 16-byte
    accesses where `vector` (the chunk lies inside the row)."""
    h0 = _row_start(row, t, plan.vec)
    out = []
    for tile in range(plan.tiles):
        for tid in range(plan.threads):
            warp, lane = divmod(tid, 32)
            j = (tile * (plan.threads // 32) + warp) * TILE_CHUNKS + lane - 1
            stores = 1 <= lane <= TILE_CHUNKS
            c = h0 + j * plan.outputs
            out.append((c, stores, c >= 0 and c + plan.outputs <= t))
    return out


# ---------------------------------------------------------------------------
# kernel wrapper: CUDA tensors launch the kernel, CPU tensors take the twin
# ---------------------------------------------------------------------------


def _lib():
    lib = build.load("snake_aa")
    if not getattr(lib, "_gsv_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gsv_snake_aa.argtypes = [P, P, P, P, L, I, I, I, I, ctypes.POINTER(ctypes.c_float), I, I, I, P]
        lib.gsv_snake_aa.restype = ctypes.c_int
        lib.gsv_snake_launch_counts.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.gsv_snake_launch_counts.restype = None
        lib.gsv_snake_reset_launch_counts.argtypes = []
        lib.gsv_snake_reset_launch_counts.restype = None
        lib._gsv_typed = True
    return lib


def _consts():
    """The kernel's constants (gsv_snake_aa `consts`): the taps, pi's parts,
    1/pi, SIN2_ZMAX and P's coefficients."""
    vals = np.concatenate([kaiser_sinc_filter1d(0.25, 0.3, TAPS), pi_parts(), [INV_PI, SIN2_ZMAX],
                           sin2_coefficients()]).astype(np.float32)
    return (ctypes.c_float * len(vals))(*vals.tolist())


_CONSTS = _consts()


def snake_aa(x, alpha, beta, *, logscale: bool = True):
    """K6. See snake_aa_plain for the function; on CUDA: x bf16 or f32
    (B, C, T), alpha and beta f32 (C,); returns x's dtype."""
    card = on_card(x)
    if card:
        refuse_trace("snake_aa", x)
    if x.ndim != 3 or x.shape[-1] < 1:
        raise ValueError(f"x: expected (B, C, T) with T >= 1, got {tuple(x.shape)}")
    b, c, t = x.shape
    dev = x.device
    check("x", x, x.dtype, (b, c, t), dev, card)
    check("alpha", alpha, torch.float32, (c,), dev, card)
    check("beta", beta, torch.float32, (c,), dev, card)
    plan = snake_plan(b * c, t, x.element_size())
    if not card:
        return snake_aa_plain(x, alpha, beta, logscale=logscale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: dtype {x.dtype}, expected bfloat16 or float32")
    refuse_grad("snake_aa", x, alpha, beta)
    y = torch.empty_like(x)
    rc = _lib().gsv_snake_aa(
        x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), y.data_ptr(), b * c, c, t, int(logscale),
        int(x.dtype == torch.bfloat16), _CONSTS, plan.tiles, plan.threads, plan.outputs,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(rc, "snake_aa")
    return y
