// Anti-aliased snakeβ activation (K6, also standing for K7) for Hopper, sm_90a.
//
// Replaces two Pallas TPU kernels of gpt_sovits_tpu/ops/pallas/snake_aa.py:
//   * `snake_aa_fused` (body `_make_kernel`, edge stitch through
//     `_xla_compose`), K6, on the (B, T, C) layout;
//   * `snake_aa_folded` (bodies `_make_folded_kernel`,
//     `_make_folded_mm_kernel`), K7, the same function on the TPU's
//     lane-folded (B, Q, r*C) layout, which exists only for the TPU's
//     128-lane tiling. The port runs PyTorch's (B, C, T) conv layout, where
//     one kernel serves every BigVGAN stage.
//
// What it computes, per (b, c) row of T samples, with the 12 taps
// f = kaiser_sinc_filter1d(0.25, 0.3, 12) and clamp(i) = min(max(i, 0), n-1):
//   u[2p]   = 2 sum_a f[2a+1] x[clamp(p+2-a)]        (x2 upsample, a = 0..5)
//   u[2p+1] = 2 sum_a f[2a]   x[clamp(p+3-a)]
//   s[m]    = u[m] + sin^2(A u[m]) / (B + 1e-9)       A, B = exp(alpha[c]),
//                                                     exp(beta[c]) (logscale)
//   y[t]    = sum_k f[k] s[clamp(2t+k-5)]             (x2 downsample, k = 0..11)
// which is the reference's upsample1d (replicate pad 5) -> snakeβ ->
// downsample1d (replicate pad 5 | 6) exactly, edges included: clamping s's
// index IS the downsample's replicate pad of the snaked stream, so no edge
// stitch is needed (the TPU kernel extends its interior formula through x
// and patches the first and last 3 samples afterwards).
//
// Layout and design: one block per (row, tile of TT outputs), a 1-D grid.
// The block stages x[t0-6 .. t0+TT+6) (clamped) in shared memory as f32,
// computes the 2TT+12 snaked samples it needs into two shared arrays (even
// and odd polyphase halves, so the downsample reads them without bank
// conflicts), then writes its TT outputs. x is read once and y written once:
// T not a multiple of TT and any channel count work, since rows and tiles
// are independent and the last tile masks its tail.
//
// What bounds it: it moves 2 x numel x element size bytes and needs 58 f32
// operations an output, an FMA counted as two: 6 FMAs for each of the two
// upsampled samples, two snakes (a u, sin, square, one FMA: 5 each) and 12
// FMAs for y. The bytes bound (3.35 TB/s) is the larger: 1.4x the
// operations bound (67 TFLOP/s f32) in bf16, 2.8x in f32. It runs about as
// fast in bf16 as in f32 (PERF.md), so neither bound holds it yet: its own
// instructions (an accurate sinf is many) and shared-memory traffic do.
// sinf, not __sinf or --use_fast_math: the accurate
// sine keeps the twin's rounding (a __sinf copy stayed inside the 2e-5 bar
// at BigVGAN's amplitudes, PERF.md, so the check cannot stand guard for it).
// The loads are 2 or 4 bytes a thread; wider loads and register tiling are
// later work.
//
// C interface: the entry returns cudaGetLastError() after its launch; every
// launch the runtime accepts adds one to the count (gsv_snake_launch_counts),
// at the launch and nowhere else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Counter { C_SNAKE, C_COUNT };
long long g_launches[C_COUNT] = {};

cudaError_t counted(Counter c) {
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++g_launches[c];
    return e;
}

constexpr int TAPS = 12;
constexpr int TT = 1024;       // outputs per block
constexpr int HALO = 6;        // x samples on each side of a tile
constexpr int THREADS = 256;

struct Taps {
    float f[TAPS];
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The snaked sample s[clamp(m)]; xs holds x[clamp(t0 - HALO + j)] at j.
__device__ __forceinline__ float snaked(int m, int two_t, int t0, const float* xs, const Taps& tp, float a,
                                        float inv_b) {
    m = min(max(m, 0), two_t - 1);
    const int p = m >> 1;
    const int odd = m & 1;
    const float* xw = xs + (p + 2 + odd) - (t0 - HALO);  // x[p + 2 + odd], then a steps back
    float u = 0.f;
#pragma unroll
    for (int a2 = 0; a2 < 6; ++a2) u = fmaf(tp.f[2 * a2 + 1 - odd], xw[-a2], u);
    u *= 2.f;
    const float sn = sinf(u * a);
    return u + inv_b * (sn * sn);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) snake_aa_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                                                           const float* __restrict__ beta, T* __restrict__ y,
                                                           int C, int Tn, int n_tiles, int logscale, Taps tp) {
    __shared__ float xs[TT + 2 * HALO];
    __shared__ float se[TT + HALO];  // se[i] = s[2(t0 - 3 + i)]
    __shared__ float so[TT + HALO];  // so[i] = s[2(t0 - 3 + i) + 1]
    const long long blk = blockIdx.x;
    const long long row = blk / n_tiles;
    const int t0 = (int)(blk % n_tiles) * TT;
    const int c = (int)(row % C);
    const T* xr = x + row * (long long)Tn;

    for (int j = threadIdx.x; j < TT + 2 * HALO; j += THREADS) {
        const int i = min(max(t0 - HALO + j, 0), Tn - 1);
        xs[j] = load_f(xr + i);
    }
    float a = alpha[c], b = beta[c];
    if (logscale) {
        a = expf(a);
        b = expf(b);
    }
    const float inv_b = 1.0f / (b + 1e-9f);
    __syncthreads();

    const int two_t = 2 * Tn;
    for (int i = threadIdx.x; i < TT + HALO; i += THREADS) {
        const int m = 2 * (t0 - 3 + i);
        se[i] = snaked(m, two_t, t0, xs, tp, a, inv_b);
        so[i] = snaked(m + 1, two_t, t0, xs, tp, a, inv_b);
    }
    __syncthreads();

    T* yr = y + row * (long long)Tn;
    for (int tau = threadIdx.x; tau < TT && t0 + tau < Tn; tau += THREADS) {
        // y[t] = sum_a f[2a+1] s[2(t+a-2)] + f[2a] s[2(t+a-3)+1]
        float acc = 0.f;
#pragma unroll
        for (int a2 = 0; a2 < 6; ++a2) {
            acc = fmaf(tp.f[2 * a2 + 1], se[tau + a2 + 1], acc);
            acc = fmaf(tp.f[2 * a2], so[tau + a2], acc);
        }
        store_f(yr + t0 + tau, acc);
    }
}

}  // namespace

extern "C" {

// x, y (rows, T) with rows = B * C, bf16 (is_bf16) or f32; alpha, beta (C)
// f32; taps (12) f32.
int gsv_snake_aa(const void* x, const float* alpha, const float* beta, void* y, long long rows, int C, int T,
                 int logscale, int is_bf16, const float* taps, void* stream) {
    Taps tp;
    for (int k = 0; k < TAPS; ++k) tp.f[k] = taps[k];
    const int n_tiles = (T + TT - 1) / TT;
    const dim3 grid((unsigned)(rows * n_tiles));
    if (is_bf16) {
        snake_aa_kernel<__nv_bfloat16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)x, alpha, beta, (__nv_bfloat16*)y, C, T, n_tiles, logscale, tp);
    } else {
        snake_aa_kernel<float><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)x, alpha, beta, (float*)y, C, T, n_tiles, logscale, tp);
    }
    return (int)counted(C_SNAKE);
}

void gsv_snake_launch_counts(long long* out) {
    for (int i = 0; i < C_COUNT; ++i) out[i] = g_launches[i];
}

void gsv_snake_reset_launch_counts() {
    for (int i = 0; i < C_COUNT; ++i) g_launches[i] = 0;
}

}  // extern "C"
