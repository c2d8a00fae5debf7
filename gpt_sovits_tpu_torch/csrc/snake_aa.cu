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
// What it computes, per (b, c) row of n samples, with the 12 taps
// f = kaiser_sinc_filter1d(0.25, 0.3, 12) and clamp(i) = min(max(i, 0), n-1):
//   u[2p]   = 2 sum_a f[2a+1] x[clamp(p+2-a)]        (x2 upsample, a = 0..5)
//   u[2p+1] = 2 sum_a f[2a]   x[clamp(p+3-a)]
//   s[m]    = u[m] + sin^2(A u[m]) / (B + 1e-9)       A, B = exp(alpha[c]),
//                                                     exp(beta[c]) (logscale)
//   y[t]    = sum_k f[k] s[clamp2(2t+k-5)]            (x2 downsample, k = 0..11)
// with clamp2 clamping to [0, 2n-1]. That is the reference's upsample1d
// (replicate pad 5) -> snakeβ -> downsample1d (replicate pad 5 | 6)
// exactly, edges included: clamping s's index IS the downsample's replicate
// pad of the snaked stream (the TPU kernel extends its interior formula
// through x and patches the first and last 3 samples afterwards).
//
// What bounds it: it moves 2 x numel x element size bytes and needs 58 f32
// operations an output (an FMA counted as two): the bytes bound (3.35 TB/s)
// is the larger, 1.4x the operations bound (67 TFLOP/s f32) in bf16, 2.8x
// in f32. What the card actually spends is instruction issue: an accurate
// sine is a range reduction and a polynomial, and every output needs two
// snaked samples, 24 FMAs of filters and its share of moving data between
// threads. The design keeps that share small:
//   * Registers hold the stream. A thread owns a chunk of R consecutive
//     outputs of one row (R = 8: one 16-byte load and store in bf16, two in
//     f32), computes its 2R snaked samples once each from its R x samples
//     and 3 on each side, and takes those 3 + 3 x samples and the 5 + 5
//     snaked samples its filters need from the neighbouring lanes with
//     __shfl_up_sync / __shfl_down_sync. The FIRs are unrolled FMAs whose
//     taps are kernel arguments (constant-bank operands).
//   * Halos. A warp is a tile of 30 chunks: lanes 1..30 store theirs,
//     lanes 0 and 31 compute the chunks on either side again and store
//     nothing, so no warp waits for another (ops/snake_aa.py snake_plan).
//     Warps exchanging their edge samples through shared memory instead
//     (a tile of 254 chunks a block, two barriers) measured slower (PERF.md).
//   * Any T and any alignment. The chunks of a row start at its first
//     16-byte boundary (`head` elements in); the chunk before it and the
//     last, partial one (when T is not a multiple of R past the head) load
//     x through clamped scalar reads and store only their positions inside
//     the row, so rows of any length (T = 1 upward) and start are served.
//     Row edges: the lane whose chunk holds position 0 replaces every
//     snaked sample before it by s[0], the lane holding n-1 every sample
//     after it by s[2n-1], before and after the exchange, which is clamp2.
//     A warp all of whose chunks lie strictly inside the row (nearly all
//     of them) takes a copy of the code with none of this (chunk<T, false>).
//   * The sine. sin^2 has period pi and no sign: k = rint(z / pi), a
//     three-part Cody-Waite r = z - k pi (exact with FMAs for |z| <= 1e5),
//     and sin^2(r) = r^2 P(r^2) on |r| <= 1.6 with 8 coefficients fitted in
//     ops/snake_aa.py (absolute error below 2.5e-7 against float64, held by
//     tests/test_torch_snake_aa.py on the same float32 arithmetic). A warp
//     with any |z| beyond 1e5 computes its chunks again in a slow function
//     that takes sinf beyond it (chunk_any_z). Not __sinf or
//     --use_fast_math, whose error grows with |z|.
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
constexpr int R = 8;  // outputs a thread: one chunk
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int POLY = 8;                            // coefficients of P(w)
constexpr int N_CONSTS = TAPS + 3 + 2 + POLY;      // taps, pi's parts, 1/pi, |z| limit, P
constexpr unsigned FULL = 0xffffffffu;

struct Consts {
    float f[TAPS];   // the taps (downsample)
    float f2[TAPS];  // 2 x the taps (upsample): sum (2f) x == 2 sum f x exactly
    float pi[3];     // pi = pi[0] + pi[1] + pi[2]
    float inv_pi;
    float zmax;      // the reduction's range; sinf beyond it
    float c[POLY];   // sin^2(r) = r^2 (c[0] + c[1] r^2 + ...)
};

// sin^2(z) for |z| <= zmax: the reduction by pi and r^2 P(r^2)
__device__ __forceinline__ float sin2(float z, const Consts& k) {
    const float n = rintf(z * k.inv_pi);
    float r = fmaf(-n, k.pi[0], z);
    r = fmaf(-n, k.pi[1], r);
    r = fmaf(-n, k.pi[2], r);
    const float w = r * r;
    float p = k.c[POLY - 1];
#pragma unroll
    for (int i = POLY - 2; i >= 0; --i) p = fmaf(p, w, k.c[i]);
    return w * p;
}

// R values of x at p[0..R): 16-byte loads
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[R]) {
#pragma unroll
    for (int q = 0; q < R / 8; ++q) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[q];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
            v[8 * q + 2 * i] = f.x;
            v[8 * q + 2 * i + 1] = f.y;
        }
    }
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[R]) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + i);
        v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[R]) {
#pragma unroll
    for (int q = 0; q < R / 8; ++q) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[8 * q + 2 * i], v[8 * q + 2 * i + 1]);
            w[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
        reinterpret_cast<uint4*>(p)[q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[R]) {
#pragma unroll
    for (int i = 0; i < R; i += 4) *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// sin^2(z): by the reduction where it holds, else by sinf
__device__ __forceinline__ float sin2_any(float z, const Consts& k) {
    if (fabsf(z) <= k.zmax) return sin2(z, k);
    const float s = sinf(z);
    return s * s;
}

// A lane's chunk, its outputs one at a time, every snaked sample computed
// from x in global memory (clamped) with sin2_any: the path of a warp in
// which some |A u| lies beyond the reduction's range. Slow, and outside the
// hot path's registers: a call after which that path only returns.
template <typename T>
__device__ __noinline__ void chunk_any_z(const T* xr, T* yr, int n, int c, float a, float inv_b, const Consts* kp) {
    const Consts& k = *kp;
    for (int i = 0; i < R; ++i) {
        const int t = c + i;
        if (t < 0 || t >= n) continue;
        float acc = 0.f;
        for (int q = 0; q < TAPS; ++q) {
            const int tap = q ^ 1;  // the order of chunk's downsample: f[1], f[0], f[3], f[2], ...
            const int m = min(max(2 * t + tap - 5, 0), 2 * n - 1);
            const int p = m >> 1, odd = m & 1;
            float u = 0.f;
            for (int s = 0; s < 6; ++s)
                u = fmaf(k.f2[2 * s + 1 - odd], load_f(xr + min(max(p + 2 + odd - s, 0), n - 1)), u);
            acc = fmaf(k.f[tap], fmaf(inv_b, sin2_any(u * a, k), u), acc);
        }
        store_f(yr + t, acc);
    }
}

// One lane's chunk: positions [c, c + R) of a row of n samples, xr and yr
// the row's x and y. EDGE: the warp holds a chunk that is not strictly
// inside the row (the row's first or last, a partial one, or one past an
// end), so loads clamp, the row's edges are fixed and stores are masked;
// otherwise every load and store is 16 bytes and nothing is checked.
template <typename T, bool EDGE>
__device__ __forceinline__ void chunk(const T* __restrict__ xr, T* __restrict__ yr, int n, int c, bool stores,
                                      float a, float inv_b, const Consts& k) {
    float xa[R + 6];  // x[c - 3 .. c + R + 3), clamped
    {
        float xv[R];
        if (!EDGE || (c >= 0 && c + R <= n)) {
            load_vec(xr + c, xv);
        } else {
#pragma unroll
            for (int i = 0; i < R; ++i) xv[i] = load_f(xr + min(max(c + i, 0), n - 1));
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            xa[i] = __shfl_up_sync(FULL, xv[R - 3 + i], 1);
            xa[R + 3 + i] = __shfl_down_sync(FULL, xv[i], 1);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) xa[3 + i] = xv[i];
    }

    // the snaked samples of the chunk's positions: even s[2p] and odd s[2p + 1]
    float se[R], so[R];
    bool big = false;  // a |z| past the reduction's range: the warp takes chunk_any_z instead
#pragma unroll
    for (int i = 0; i < R; ++i) {
        float ue = 0.f, uo = 0.f;
#pragma unroll
        for (int t = 0; t < 6; ++t) {
            ue = fmaf(k.f2[2 * t + 1], xa[i + 5 - t], ue);
            uo = fmaf(k.f2[2 * t], xa[i + 6 - t], uo);
        }
        const float ze = ue * a, zo = uo * a;
        big |= fabsf(ze) > k.zmax || fabsf(zo) > k.zmax;
        se[i] = fmaf(inv_b, sin2(ze, k), ue);
        so[i] = fmaf(inv_b, sin2(zo, k), uo);
    }
    if (__any_sync(FULL, big)) {  // never at BigVGAN's amplitudes; kept exact for any input
        if (stores) chunk_any_z(xr, yr, n, c, a, inv_b, &k);
        return;
    }

    // row edges: every sample before position 0 is s[0], every one after
    // position n - 1 is s[2n - 1]
    const bool first = EDGE && c <= 0 && c + R > 0, last = EDGE && c <= n - 1 && c + R > n - 1;
    float s0 = 0.f, s1 = 0.f;
    if (first) {
#pragma unroll
        for (int i = 0; i < R; ++i)
            if (i == -c) s0 = se[i];
#pragma unroll
        for (int i = 0; i < R; ++i)
            if (i < -c) se[i] = so[i] = s0;
    }
    if (last) {
#pragma unroll
        for (int i = 0; i < R; ++i)
            if (i == n - 1 - c) s1 = so[i];
#pragma unroll
        for (int i = 0; i < R; ++i)
            if (i > n - 1 - c) se[i] = so[i] = s1;
    }

    // what the downsample reads: 2 even and 3 odd samples before the chunk,
    // 3 even and 2 odd after it, from the neighbouring lanes
    float sa_e[R + 5];  // s[2p] for p in [c - 2, c + R + 3)
    float sa_o[R + 5];  // s[2p + 1] for p in [c - 3, c + R + 2)
#pragma unroll
    for (int i = 0; i < R; ++i) {
        sa_e[2 + i] = se[i];
        sa_o[3 + i] = so[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        sa_e[i] = __shfl_up_sync(FULL, se[R - 2 + i], 1);
        sa_o[R + 3 + i] = __shfl_down_sync(FULL, so[i], 1);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        sa_o[i] = __shfl_up_sync(FULL, so[R - 3 + i], 1);
        sa_e[R + 2 + i] = __shfl_down_sync(FULL, se[i], 1);
    }
    if (!stores || (EDGE && (c >= n || c + R <= 0))) return;
    if (first) {  // the samples before the chunk are all before position 0
        sa_e[0] = sa_e[1] = s0;
        sa_o[0] = sa_o[1] = sa_o[2] = s0;
    }
    if (last) {  // the samples after the chunk are all after position n - 1
        sa_e[R + 2] = sa_e[R + 3] = sa_e[R + 4] = s1;
        sa_o[R + 3] = sa_o[R + 4] = s1;
    }

    // y[t] = sum_a f[2a+1] s[2(t+a-2)] + f[2a] s[2(t+a-3)+1]
    float yv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < 6; ++t) {
            acc = fmaf(k.f[2 * t + 1], sa_e[i + t], acc);
            acc = fmaf(k.f[2 * t], sa_o[i + t], acc);
        }
        yv[i] = acc;
    }
    if (!EDGE || (c >= 0 && c + R <= n)) {
        store_vec(yr + c, yv);
    } else {
#pragma unroll
        for (int i = 0; i < R; ++i)
            if (c + i >= 0 && c + i < n) store_f(yr + c + i, yv[i]);
    }
}

// One block: WARPS warp tiles of row `blockIdx.x / tiles`, its tile
// `blockIdx.x % tiles`. A warp tile is 30 chunks: lane l takes chunk j of
// the row, positions [c, c + R) with c = h0 + j R, lanes 1..30 store it,
// lanes 0 and 31 compute the chunks on either side again for their
// neighbours (ops/snake_aa.py lane_chunks computes the same).
template <typename T>
__global__ void __launch_bounds__(THREADS) snake_aa_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                                                           const float* __restrict__ beta, T* __restrict__ y, int C,
                                                           int n, int tiles, int logscale,
                                                           const __grid_constant__ Consts k) {
    constexpr int V = 16 / sizeof(T);  // elements of a 16-byte word
    const int row = (int)(blockIdx.x / tiles);
    const int tile = (int)(blockIdx.x % tiles);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j = (tile * WARPS + warp) * 30 + lane - 1;
    const long long start = (long long)row * n;             // the row's first element
    const int head = (int)((V - start % V) % V);            // elements before the row's first 16-byte boundary
    const int h0 = head > 0 ? head - R : 0;                 // chunk 0 ends at that boundary
    const int c = h0 + j * R;
    if (!__any_sync(FULL, c < n + R)) return;               // past the chunk after the row's last: no one's
    const int ch = row % C;
    float a = alpha[ch], b = beta[ch];
    if (logscale) {
        a = expf(a);
        b = expf(b);
    }
    const float inv_b = 1.0f / (b + 1e-9f);
    const bool stores = lane >= 1 && lane <= 30;
    if (__all_sync(FULL, c > 0 && c + R < n))
        chunk<T, false>(x + start, y + start, n, c, stores, a, inv_b, k);
    else
        chunk<T, true>(x + start, y + start, n, c, stores, a, inv_b, k);
}

template <typename T>
cudaError_t launch(const void* x, const float* alpha, const float* beta, void* y, unsigned grid, int C, int n,
                   int tiles, int logscale, const Consts& k, cudaStream_t st) {
    snake_aa_kernel<T><<<grid, THREADS, 0, st>>>((const T*)x, alpha, beta, (T*)y, C, n, tiles, logscale, k);
    return counted(C_SNAKE);
}

}  // namespace

extern "C" {

// x, y (rows, T) with rows = B * C, bf16 (is_bf16) or f32, 16-byte aligned;
// alpha, beta (C) f32. consts: the 12 taps, pi's three parts, 1/pi, the
// reduction's |z| limit and the 8 coefficients of P. The plan
// (ops/snake_aa.py snake_plan): `tiles` blocks a row of `threads` threads,
// `outputs` a thread.
int gsv_snake_aa(const void* x, const float* alpha, const float* beta, void* y, long long rows, int C, int T,
                 int logscale, int is_bf16, const float* consts, int tiles, int threads, int outputs, void* stream) {
    if (threads != THREADS || outputs != R || tiles < 1 || rows < 1 || T < 1 || rows * tiles > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    Consts k;
    for (int i = 0; i < TAPS; ++i) {
        k.f[i] = consts[i];
        k.f2[i] = 2.f * consts[i];
    }
    for (int i = 0; i < 3; ++i) k.pi[i] = consts[TAPS + i];
    k.inv_pi = consts[TAPS + 3];
    k.zmax = consts[TAPS + 4];
    for (int i = 0; i < POLY; ++i) k.c[i] = consts[TAPS + 5 + i];
    static_assert(TAPS + 5 + POLY == N_CONSTS, "consts layout");
    const unsigned grid = (unsigned)(rows * tiles);
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(is_bf16 ? launch<__nv_bfloat16>(x, alpha, beta, y, grid, C, T, tiles, logscale, k, st)
                         : launch<float>(x, alpha, beta, y, grid, C, T, tiles, logscale, k, st));
}

void gsv_snake_launch_counts(long long* out) {
    for (int i = 0; i < C_COUNT; ++i) out[i] = g_launches[i];
}

void gsv_snake_reset_launch_counts() {
    for (int i = 0; i < C_COUNT; ++i) g_launches[i] = 0;
}

}  // extern "C"
