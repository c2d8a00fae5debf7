// int8 DiT projections (K2, K3) for Hopper, sm_90a.
//
// Replaces two Pallas TPU kernels of gpt_sovits_tpu/ops/pallas/qmatmul.py:
//   * `qdense_int8` (body `_make_qmm_kernel`), K2: y = (round(x / sx) @ Wq)
//     * sx * sw + b with a dynamic per-row activation scale
//     sx = max(max|x| / 127, 1e-8), s8 x s8 -> s32, and the DiT block's glue:
//     an optional LayerNorm (no affine, eps 1e-6) + AdaLN prologue
//     ln(x) * (1 + sc) + sh, a tanh-gelu epilogue, pad-row zeroing and a
//     gated residual res + gate * y.
//   * `qkv_rope_int8` (body `_qkv_rope_kernel`), K3: the same prologue, x
//     quantized once for three projections (q, k, v), rotary embedding on
//     the first dim_head channels of q and k only (interleaved pairs), an
//     optional static q scale, and the (B, H, T, dim_head) layout of K5.
//
// Each is two launches: row_quant (prologue, per-row scale, int8 codes of
// x: x is read and quantized exactly once, as on the TPU) and a GEMM
// (qdense / qkv_rope) whose epilogue applies the glue. Weights are int8 in
// PyTorch's Linear layout (N, K), so both MMA operands are K-contiguous.
//
// What bounds them: at the main path's shapes (M = B x 1024 rows, K and N
// 1024 or 2048) a projection does 2MNK int8 operations on ~M(K+N)x2 + NK
// bytes: 60-340 operations a byte, at or above the card's int8 ridge
// (1979 TOP/s over 3.35 TB/s, ~590 operations a byte) only for the larger
// batches. So the floor is the int8 tensor-core rate for B >= 4 and the
// bytes below.
//
// What this first version does about it: a plain mma.sync m16n8k32 s8 GEMM
// (128 x 128 x 64 block tiles, 8 warps of 64 x 32, cp.async double
// buffering, no wgmma/TMA), which reaches a fraction of the int8 peak;
// PERF.md records how far each launch is from its bound. wgmma with TMA
// and a fused prologue are later work.
//
// Numerics follow the TPU kernels: activations are multiplied by the
// exactly rounded reciprocal of their scale and rounded half to even
// (rintf); LayerNorm, the scales and the epilogue run in f32; outputs are
// rounded to bf16 once, after the rotary embedding.
//
// C interface: each entry returns cudaGetLastError() after its launch;
// every launch the runtime accepts adds one to its kernel's count
// (gsv_qmm_launch_counts), at the launch and nowhere else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Counter { C_ROWQ, C_QDENSE, C_QKV, C_COUNT };
long long g_launches[C_COUNT] = {};

cudaError_t counted(Counter c) {
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++g_launches[c];
    return e;
}

constexpr float INV127 = (float)(1.0 / 127.0);

// ---------------------------------------------------------------------------
// row_quant: one block per row of x (bf16, K <= 2048): optional LN + AdaLN,
// the row's scale and its int8 codes.
// ---------------------------------------------------------------------------

constexpr int RQ_THREADS = 128;
constexpr int RQ_VEC = 8;         // bf16 values per 16-byte load
constexpr int RQ_CHUNKS = 2;      // K <= RQ_CHUNKS * RQ_THREADS * RQ_VEC = 2048
constexpr int RQ_WARPS = RQ_THREADS / 32;

__device__ float block_sum(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    __syncthreads();  // red[] may still be read by the previous reduction
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < RQ_WARPS; ++w) s += red[w];
    return s;
}

__device__ float block_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = red[0];
    for (int w = 1; w < RQ_WARPS; ++w) s = fmaxf(s, red[w]);
    return s;
}

__global__ void __launch_bounds__(RQ_THREADS) row_quant_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ sc, const float* __restrict__ sh,
    int8_t* __restrict__ xq, float* __restrict__ sx_out, int K, int T, int has_ln) {
    __shared__ float red[RQ_WARPS];
    const long long row = blockIdx.x;
    const __nv_bfloat16* xr = x + row * K;
    float v[RQ_CHUNKS][RQ_VEC];
    bool live[RQ_CHUNKS];
#pragma unroll
    for (int c = 0; c < RQ_CHUNKS; ++c) {
        const int k0 = (c * RQ_THREADS + threadIdx.x) * RQ_VEC;
        live[c] = k0 < K;
        if (live[c]) {
            const uint4 raw = *reinterpret_cast<const uint4*>(xr + k0);
            const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int j = 0; j < RQ_VEC / 2; ++j) {
                const float2 f = __bfloat1622float2(p[j]);
                v[c][2 * j] = f.x;
                v[c][2 * j + 1] = f.y;
            }
        } else {
#pragma unroll
            for (int j = 0; j < RQ_VEC; ++j) v[c][j] = 0.f;
        }
    }
    if (has_ln) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < RQ_CHUNKS; ++c)
#pragma unroll
            for (int j = 0; j < RQ_VEC; ++j) s += v[c][j];
        const float mu = block_sum(s, red) / (float)K;
        float q = 0.f;
#pragma unroll
        for (int c = 0; c < RQ_CHUNKS; ++c)
            if (live[c])
#pragma unroll
                for (int j = 0; j < RQ_VEC; ++j) q += (v[c][j] - mu) * (v[c][j] - mu);
        const float var = block_sum(q, red) / (float)K;
        const float rs = 1.0f / sqrtf(var + 1e-6f);
        const long long b = row / T;
        const float* scb = sc + b * K;
        const float* shb = sh + b * K;
#pragma unroll
        for (int c = 0; c < RQ_CHUNKS; ++c) {
            if (!live[c]) continue;
            const int k0 = (c * RQ_THREADS + threadIdx.x) * RQ_VEC;
#pragma unroll
            for (int j = 0; j < RQ_VEC; ++j) {
                const float xn = (v[c][j] - mu) * rs;
                v[c][j] = xn * (1.0f + scb[k0 + j]) + shb[k0 + j];
            }
        }
    }
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < RQ_CHUNKS; ++c)
        if (live[c])
#pragma unroll
            for (int j = 0; j < RQ_VEC; ++j) m = fmaxf(m, fabsf(v[c][j]));
    const float sxv = fmaxf(block_max(m, red) * INV127, 1e-8f);
    const float inv = 1.0f / sxv;
#pragma unroll
    for (int c = 0; c < RQ_CHUNKS; ++c) {
        if (!live[c]) continue;
        const int k0 = (c * RQ_THREADS + threadIdx.x) * RQ_VEC;
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < RQ_VEC; ++j) {
            const float qv = fminf(fmaxf(rintf(v[c][j] * inv), -127.f), 127.f);
            w[j >> 2] |= (uint32_t)(uint8_t)(int8_t)qv << (8 * (j & 3));
        }
        *reinterpret_cast<uint2*>(xq + row * K + k0) = make_uint2(w[0], w[1]);
    }
    if (threadIdx.x == 0) sx_out[row] = sxv;
}

// ---------------------------------------------------------------------------
// The s8 GEMM main loop: acc[128 x 128 tile] = xq[m0.., :] . W[n0.., :]^T
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // bytes per shared row: 80, so fragment loads hit 32 banks
constexpr int GEMM_THREADS = 256;

struct GemmSmem {
    int8_t a[2][BM][LDS];
    int8_t b[2][BN][LDS];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) { return *reinterpret_cast<const unsigned*>(p); }

// Each warp owns a 64 x 32 piece of the tile: rows wm + mi*16 + {g, g+8},
// columns wn + ni*8 + {2t, 2t+1} of acc[mi][ni][{0,1 | 2,3}].
__device__ __forceinline__ void gemm_tile(const int8_t* __restrict__ xq, const int8_t* __restrict__ w, int M, int K,
                                          int m0, int n0, GemmSmem& sm, int (&acc)[4][4][4]) {
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

    auto load = [&](int stage, int k0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int c = tid + i * GEMM_THREADS;  // 512 16-byte chunks per operand tile
            const int r = c >> 2, col = (c & 3) * 16;
            const int gm = m0 + r;
            const bool ok = gm < M;
            cp_async16(&sm.a[stage][r][col], xq + (long long)(ok ? gm : 0) * K + k0 + col, ok);
            cp_async16(&sm.b[stage][r][col], w + (long long)(n0 + r) * K + k0 + col, true);
        }
        cp_async_commit();
    };

    const int nk = K / BK;
    load(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) {
            load((kt + 1) & 1, (kt + 1) * BK);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int st = kt & 1;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
            unsigned a[4][4], b[4][2];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                const int r = wm + mi * 16 + g;
                a[mi][0] = lds32(&sm.a[st][r][kk + t * 4]);
                a[mi][1] = lds32(&sm.a[st][r + 8][kk + t * 4]);
                a[mi][2] = lds32(&sm.a[st][r][kk + 16 + t * 4]);
                a[mi][3] = lds32(&sm.a[st][r + 8][kk + 16 + t * 4]);
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int n = wn + ni * 8 + g;
                b[ni][0] = lds32(&sm.b[st][n][kk + t * 4]);
                b[ni][1] = lds32(&sm.b[st][n][kk + 16 + t * 4]);
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
        }
        __syncthreads();  // the next iteration's load overwrites this stage
    }
}

__device__ __forceinline__ float gelu_tanh(float y) {
    return 0.5f * y * (1.0f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
}

// ---------------------------------------------------------------------------
// qdense (K2): out (M, N) bf16 = epilogue(acc * sx[row] * sw[col] + b[col])
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(GEMM_THREADS) qdense_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const int8_t* __restrict__ w,
    const float* __restrict__ sw, const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    const float* __restrict__ gate, const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int M, int N,
    int K, int T, int gelu) {
    __shared__ __align__(16) GemmSmem sm;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    int acc[4][4][4];
    gemm_tile(xq, w, M, K, m0, n0, sm, acc);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = m0 + wm + mi * 16 + g + hr * 8;
            if (row >= M) continue;
            const float sxr = sx[row];
            const bool keep = mask == nullptr || mask[row] > 0.f;
            const long long b = row / T;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int col = n0 + wn + ni * 8 + t * 2;
                float y[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float v = (float)acc[mi][ni][hr * 2 + e] * sxr * sw[col + e] + bias[col + e];
                    if (gelu) v = gelu_tanh(v);
                    if (!keep) v = 0.f;
                    y[e] = v;
                }
                const long long o = (long long)row * N + col;
                if (res != nullptr) {
                    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + o));
                    y[0] = r.x + gate[b * N + col] * y[0];
                    y[1] = r.y + gate[b * N + col + 1] * y[1];
                }
                *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(y[0], y[1]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// qkv_rope (K3): blockIdx.z picks q (0), k (1) or v (2); rows are (b, t),
// columns (head, d); out[z] (B, H, T, dh) bf16. Rotary pairs (2i, 2i+1) of
// the first dh columns (head 0) sit in one thread's two accumulators.
// ---------------------------------------------------------------------------

struct QkvArgs {
    const int8_t* w[3];
    const float* s[3];
    const float* b[3];
    __nv_bfloat16* out[3];
};

__global__ void __launch_bounds__(GEMM_THREADS) qkv_rope_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, QkvArgs args, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int M, int N, int K, int T, int dh, float q_scale) {
    __shared__ __align__(16) GemmSmem sm;
    const int z = blockIdx.z;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    int acc[4][4][4];
    gemm_tile(xq, args.w[z], M, K, m0, n0, sm, acc);

    const float* __restrict__ sw = args.s[z];
    const float* __restrict__ bias = args.b[z];
    __nv_bfloat16* __restrict__ out = args.out[z];
    const int H = N / dh, half = dh / 2;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = m0 + wm + mi * 16 + g + hr * 8;
            if (row >= M) continue;
            const float sxr = sx[row];
            const int bt = row / T, tt = row % T;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int col = n0 + wn + ni * 8 + t * 2;
                float y0 = (float)acc[mi][ni][hr * 2] * sxr * sw[col] + bias[col];
                float y1 = (float)acc[mi][ni][hr * 2 + 1] * sxr * sw[col + 1] + bias[col + 1];
                if (z < 2 && col < dh) {
                    const float c = cos_t[tt * half + col / 2], s = sin_t[tt * half + col / 2];
                    const float r0 = y0 * c + (-y1) * s;
                    const float r1 = y1 * c + y0 * s;
                    y0 = r0;
                    y1 = r1;
                }
                if (z == 0 && q_scale != 1.0f) {
                    y0 *= q_scale;
                    y1 *= q_scale;
                }
                const int head = col / dh, d = col % dh;
                const long long o = (((long long)bt * H + head) * T + tt) * dh + d;
                *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(y0, y1);
            }
        }
    }
}

}  // namespace

extern "C" {

// x (M, K) bf16 -> xq (M, K) int8, sx (M) f32; sc/sh (M / T, K) f32 when has_ln.
int gsv_row_quant(const void* x, const float* sc, const float* sh, int8_t* xq, float* sx, int M, int K, int T,
                  int has_ln, void* stream) {
    row_quant_kernel<<<M, RQ_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, sc, sh, xq, sx, K, T, has_ln);
    return (int)counted(C_ROWQ);
}

// K % 64 == 0, N % 128 == 0. res (M, N) bf16 and gate (M / T, N) f32, or both
// null; mask (M) f32 or null; out (M, N) bf16.
int gsv_qdense(const int8_t* xq, const float* sx, const int8_t* w, const float* sw, const float* bias, const void* res,
               const float* gate, const float* mask, void* out, int M, int N, int K, int T, int gelu, void* stream) {
    const dim3 grid(N / BN, (M + BM - 1) / BM);
    qdense_kernel<<<grid, GEMM_THREADS, 0, (cudaStream_t)stream>>>(
        xq, sx, w, sw, bias, (const __nv_bfloat16*)res, gate, mask, (__nv_bfloat16*)out, M, N, K, T, gelu);
    return (int)counted(C_QDENSE);
}

// three (N, K) int8 weights; cos/sin (T, dh / 2) f32; q, k, v (M / T, N / dh, T, dh) bf16.
int gsv_qkv_rope(const int8_t* xq, const float* sx, const int8_t* wq, const int8_t* wk, const int8_t* wv,
                 const float* sq, const float* sk, const float* sv, const float* bq, const float* bk, const float* bv,
                 const float* cos_t, const float* sin_t, void* q, void* k, void* v, int M, int N, int K, int T, int dh,
                 float q_scale, void* stream) {
    QkvArgs a;
    a.w[0] = wq; a.w[1] = wk; a.w[2] = wv;
    a.s[0] = sq; a.s[1] = sk; a.s[2] = sv;
    a.b[0] = bq; a.b[1] = bk; a.b[2] = bv;
    a.out[0] = (__nv_bfloat16*)q; a.out[1] = (__nv_bfloat16*)k; a.out[2] = (__nv_bfloat16*)v;
    const dim3 grid(N / BN, (M + BM - 1) / BM, 3);
    qkv_rope_kernel<<<grid, GEMM_THREADS, 0, (cudaStream_t)stream>>>(xq, sx, a, cos_t, sin_t, M, N, K, T, dh, q_scale);
    return (int)counted(C_QKV);
}

void gsv_qmm_launch_counts(long long* out) {
    for (int i = 0; i < C_COUNT; ++i) out[i] = g_launches[i];
}

void gsv_qmm_reset_launch_counts() {
    for (int i = 0; i < C_COUNT; ++i) g_launches[i] = 0;
}

}  // extern "C"
