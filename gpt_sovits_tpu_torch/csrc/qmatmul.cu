// int8 DiT projections (K2, K3, K4) for Hopper, sm_90a.
//
// Replaces three Pallas TPU kernels of gpt_sovits_tpu/ops/pallas/qmatmul.py:
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
//   * `qdense_out_int8` (body `_make_heads_in_kernel`), K4: the attention
//     output projection of the DiT's long-chunk branch, reading the
//     (B, H, T, dh) layout of the attention directly. Its activation scale
//     per row is the max over heads of each head's row max, which is the row
//     max of the merged (T, H*dh) matrix, and its per-head s8 dots summed
//     over heads are the merged row's s8 dot. So K4 is K2 on the merged
//     layout: row_quant_heads (row_quant with the head merge done in its
//     loads, no transpose through memory) and the same GEMM, whose epilogue
//     applies the bias, the pad-row mask and the gated residual.
//
// Each is two launches: row_quant, or row_quant_heads for K4 (prologue,
// per-row scale, int8 codes of x: x is read and quantized exactly once, as
// on the TPU) and a GEMM (qdense, whose kernel K4 shares, or qkv_rope) whose
// epilogue applies the glue. Weights are int8 in
// PyTorch's Linear layout (N, K), so both MMA operands are K-contiguous.
//
// What bounds them: at the main path's shapes (M = B x 1024 rows, K and N
// 1024 or 2048) a projection does 2MNK int8 operations on ~M(K+N)x2 + NK
// bytes: 60-340 operations a byte, at or above the card's int8 ridge
// (1979 TOP/s over 3.35 TB/s, ~590 operations a byte) only for the larger
// batches. So the floor is the int8 tensor-core rate for B >= 4 and the
// bytes below.
//
// What the design does about it. One GEMM serves all three
// (gemm_tile_staged), and it is Hopper's: a producer warp keeps TMA loads of
// 128-byte-deep K slices in flight through a 3-4 slot ring (128-byte
// swizzle, mbarriers), and two consumer warpgroups run wgmma m64nNk32 s8
// straight from shared memory, so no thread spends instructions on operand
// loads; the s32 tile is staged through the idle ring, and the epilogue
// moves res and out in 16-byte accesses. Tiles are 128 x 64 (or 128 x 128
// where the grid is large: ops/qmatmul.py gemm_plan, which counts K3's three
// projections in its grid), so M = 1024, N = 1024 launches 128 blocks on
// the 132 SMs, where 128 x 128 tiles would launch 64; two blocks fit an SM.
// K3 launches one grid over (column tile, row block, projection): blockIdx.z
// picks q, k or v through its own weight tensor map. PERF.md records how far
// each launch is from its bound.
//
// Numerics follow the TPU kernels: activations are multiplied by the
// exactly rounded reciprocal of their scale and rounded half to even
// (rintf); LayerNorm, the scales and the epilogue run in f32; outputs are
// rounded to bf16 once, after the rotary embedding.
//
// C interface: each entry returns cudaGetLastError() after its launch;
// every launch the runtime accepts adds one to its kernel's count
// (gsv_qmm_launch_counts), at the launch and nowhere else.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Counter { C_ROWQ, C_QDENSE, C_QKV, C_ROWQH, C_QOUT, C_COUNT };
long long g_launches[C_COUNT] = {};

cudaError_t counted(Counter c) {
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++g_launches[c];
    return e;
}

constexpr float INV127 = (float)(1.0 / 127.0);

// ---------------------------------------------------------------------------
// row_quant: one block per row of x (bf16, K <= 2048): optional LN + AdaLN,
// the row's scale and its int8 codes. HEADS: x is (B, H, T, dh) and row
// b * T + t gathers its K = H * dh values head by head (dh % 8 == 0, so each
// 16-byte load lies in one head); no LN.
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

template <bool HEADS>
__global__ void __launch_bounds__(RQ_THREADS) row_quant_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ sc, const float* __restrict__ sh,
    int8_t* __restrict__ xq, float* __restrict__ sx_out, int K, int T, int has_ln, int dh) {
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
            const __nv_bfloat16* src = xr + k0;
            if (HEADS) {  // head k0 / dh of row (b, t): x[b, k0 / dh, t, k0 % dh]
                const long long b = row / T, t = row % T, H = K / dh;
                src = x + ((b * H + k0 / dh) * T + t) * dh + k0 % dh;
            }
            const uint4 raw = *reinterpret_cast<const uint4*>(src);
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
// Hopper building blocks: mbarriers, TMA tile loads, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A wait
// of more than ~10 s of clocks traps: a lost load or arrival ends the kernel
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    const long long t0 = clock64();
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (!done && clock64() - t0 > 20000000000LL) __trap();
    } while (!done);
}

__device__ __forceinline__ void fence_barrier_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A box of the 2-D tensor map at (c0 innermost, c1) into shared memory;
// completion is counted in bytes on `bar`. Out-of-bounds elements are zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :
        : "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accumulator accesses across wgmma's
// asynchronous reads and writes of them.
template <int R>
__device__ __forceinline__ void reg_fence(int (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma descriptor of a K-major tile whose rows are 128 bytes, stored as TMA's
// 128-byte swizzle writes it (8-row atoms of 1024 bytes, 1024-byte aligned).
// Advancing the start address by 32 bytes steps k by one s8 wgmma.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
           ((uint64_t)1 << 62);
}

// D (64 x N, s32) += A (64 x 32, s8, shared) . B (N x 32, s8, shared)^T
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b) {
    if constexpr (BN == 64)
        wgmma_s8_n64(d, a, b, 1);
    else
        wgmma_s8_n128(d, a, b, 1);
}

__device__ __forceinline__ float gelu_tanh(float y) {
    return 0.5f * y * (1.0f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
}

// ---------------------------------------------------------------------------
// The s8 GEMM of one 128 x BN output tile, shared by qdense (K2, K4's GEMM)
// and qkv_rope (K3): acc = xq[m0.., :] . W[n0.., :]^T.
//
// Warp 8 is the producer: one thread streams 128-byte-deep K slices of x
// (128 rows) and W (BN rows) by TMA into a ring of STAGES slots, each with a
// `full` barrier (the TMA bytes) and an `empty` barrier (every consumer
// thread's release). Warpgroups 0 and 1 each own 64 rows of the tile and
// run wgmma m64nBNk32 s8 from the slots as they arrive. Rows past M and K
// past its end load as zeros. The s32 tile is then staged through the (by
// then idle) ring, so that each epilogue thread finishes 8 consecutive
// columns of a row with 16-byte accesses; sw and bias of the tile's columns
// sit in shared memory, loaded once per tile.
// ---------------------------------------------------------------------------

constexpr int GEMM_CONSUMERS = 256;                 // two warpgroups
constexpr int GEMM_THREADS_HOPPER = GEMM_CONSUMERS + 32;  // and the producer warp

template <int BN>
struct GemmCfg {
    static constexpr int BM = 128, BK = 128;  // rows, bytes of K per slot
    static constexpr int STAGES = BN == 64 ? 4 : 3;
    static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
    static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
    static constexpr int EPI_LD = BN + 8;  // s32 per staged row: the fragment stores hit 32 banks
    static constexpr int RING = STAGES * STAGE_BYTES;
    static constexpr int SMEM = 1024 + RING + 2 * BN * 4 + 2 * STAGES * 8;
    static_assert(BM * EPI_LD * 4 <= RING, "the epilogue's staging fits in the ring");
};

// The GEMM's dynamic shared memory from a 1024-byte aligned base: the ring
// (A slots, then B slots), the tile's sw and bias, the full and empty barriers.
template <int BN>
struct GemmRing {
    using C = GemmCfg<BN>;
    uint8_t* base;
    float* s_sw;
    float* s_bias;
    uint64_t* full;
    uint64_t* empty;
    __device__ explicit GemmRing(uint8_t* dyn)
        : base(dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023)),
          s_sw(reinterpret_cast<float*>(base + C::RING)),
          s_bias(s_sw + BN),
          full(reinterpret_cast<uint64_t*>(s_bias + BN)),
          empty(full + C::STAGES) {}
    __device__ uint8_t* a(int s) const { return base + s * C::A_BYTES; }
    __device__ uint8_t* b(int s) const { return base + C::STAGES * C::A_BYTES + s * C::B_BYTES; }
    __device__ const int* staged() const { return reinterpret_cast<const int*>(base); }
};

// Every thread of the block: the barriers, and the tile's sw and bias.
template <int BN>
__device__ __forceinline__ void gemm_setup(const GemmRing<BN>& ring, const float* __restrict__ sw,
                                           const float* __restrict__ bias, int n0) {
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < GemmCfg<BN>::STAGES; ++s) {
            mbar_init(&ring.full[s], 1);
            mbar_init(&ring.empty[s], GEMM_CONSUMERS);
        }
        fence_barrier_init();
    }
    if (tid < BN) {
        ring.s_sw[tid] = sw[n0 + tid];
        ring.s_bias[tid] = bias[n0 + tid];
    }
    __syncthreads();
}

// The producer warp streams the tile's K slices and returns false; the
// consumer threads return true once the s32 tile is staged in the ring
// (row r, column c at staged()[r * EPI_LD + c]).
template <int BN>
__device__ __forceinline__ bool gemm_tile_staged(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                                 const GemmRing<BN>& ring, int m0, int n0, int K) {
    using C = GemmCfg<BN>;
    const int nk = (K + C::BK - 1) / C::BK;
    const int tid = threadIdx.x;
    if (tid >= GEMM_CONSUMERS) {  // the producer warp
        if (tid == GEMM_CONSUMERS) {
            for (int kt = 0; kt < nk; ++kt) {
                const int s = kt % C::STAGES;
                mbar_wait(&ring.empty[s], ((kt / C::STAGES) & 1) ^ 1);
                mbar_expect_tx(&ring.full[s], C::STAGE_BYTES);
                tma_load_2d(ring.a(s), tm_x, kt * C::BK, m0, &ring.full[s]);
                tma_load_2d(ring.b(s), tm_w, kt * C::BK, n0, &ring.full[s]);
            }
        }
        return false;
    }

    const int wg = tid >> 7;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll 1
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::STAGES;
        mbar_wait(&ring.full[s], (kt / C::STAGES) & 1);
        const uint8_t* a = ring.a(s) + wg * 64 * C::BK;
        const uint8_t* b = ring.b(s);
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int k = 0; k < C::BK / 32; ++k) wgmma_s8<BN>(acc, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k));
        wg_commit();
        wg_wait0();
        reg_fence(acc);
        mbar_arrive(&ring.empty[s]);
    }

    // every slot has been consumed, so the ring holds the s32 tile
    named_sync(1, GEMM_CONSUMERS);
    int* stage = reinterpret_cast<int*>(ring.base);
    {
        const int warp = (tid & 127) >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
        const int r = wg * 64 + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int col = j * 8 + 2 * q;
            *reinterpret_cast<int2*>(&stage[r * C::EPI_LD + col]) = make_int2(acc[4 * j], acc[4 * j + 1]);
            *reinterpret_cast<int2*>(&stage[(r + 8) * C::EPI_LD + col]) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
        }
    }
    named_sync(1, GEMM_CONSUMERS);
    return true;
}

// the 8 staged s32 sums of row r from column c8, as acc * sx * sw + bias (f32)
template <int BN>
__device__ __forceinline__ void staged_row8(const GemmRing<BN>& ring, int r, int c8, float sxr, float (&y)[8]) {
    const int* st = ring.staged() + r * GemmCfg<BN>::EPI_LD + c8;
    const int4 a0 = *reinterpret_cast<const int4*>(st);
    const int4 a1 = *reinterpret_cast<const int4*>(st + 4);
    const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = (float)av[e] * sxr * ring.s_sw[c8 + e] + ring.s_bias[c8 + e];
}

__device__ __forceinline__ void store_bf16x8(__nv_bfloat16* dst, const float (&y)[8]) {
    uint4 packed;
    __nv_bfloat162* pp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) pp[e] = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
    *reinterpret_cast<uint4*>(dst) = packed;
}

// ---------------------------------------------------------------------------
// qdense (K2, and K4's GEMM): out (M, N) bf16 = epilogue(acc * sx[row] * sw[col] + b[col])
// One block per 128 x BN output tile; the epilogue adds gelu, the pad-row
// mask and the gated residual (16-byte loads of res).
// ---------------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS_HOPPER, 2) qdense_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    const float* __restrict__ gate, const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int M, int N,
    int K, int T, int gelu) {
    using C = GemmCfg<BN>;
    extern __shared__ __align__(1024) uint8_t dyn_smem[];
    const GemmRing<BN> ring(dyn_smem);
    const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * BN;
    gemm_setup<BN>(ring, sw, bias, n0);
    if (!gemm_tile_staged<BN>(&tm_x, &tm_w, ring, m0, n0, K)) return;

    constexpr int GROUPS = BN / 8;
    for (int idx = threadIdx.x; idx < C::BM * GROUPS; idx += GEMM_CONSUMERS) {
        const int r = idx / GROUPS, c8 = (idx % GROUPS) * 8;
        const int row = m0 + r;
        if (row >= M) break;
        const bool keep = mask == nullptr || mask[row] > 0.f;
        float y[8];
        staged_row8<BN>(ring, r, c8, sx[row], y);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            float v = y[e];
            if (gelu) v = gelu_tanh(v);
            if (!keep) v = 0.f;
            y[e] = v;
        }
        const long long o = (long long)row * N + n0 + c8;
        if (res != nullptr) {
            const uint4 rr = *reinterpret_cast<const uint4*>(res + o);
            const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rr);
            const float* gp = gate + (long long)(row / T) * N + n0 + c8;
            const float4 g0 = *reinterpret_cast<const float4*>(gp), g1 = *reinterpret_cast<const float4*>(gp + 4);
            const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 rf = __bfloat1622float2(rp[e]);
                y[2 * e] = rf.x + gv[2 * e] * y[2 * e];
                y[2 * e + 1] = rf.y + gv[2 * e + 1] * y[2 * e + 1];
            }
        }
        store_bf16x8(out + o, y);
    }
}

// ---------------------------------------------------------------------------
// qkv_rope (K3): the same GEMM, blockIdx.z picking q (0), k (1) or v (2)
// through three weight tensor maps (x's codes are the same for all three);
// rows are (b, t), columns (head, d); out[z] (B, H, T, dh) bf16, dh % 8 == 0.
// Each epilogue thread finishes 8 consecutive columns, i.e. four whole
// rotary pairs (2i, 2i+1) of one head: for head 0 of q and k it rotates them
// with the f32 table of position t, then q takes q_scale, then the 8 values
// are rounded to bf16 once and stored as 16 bytes at (b, head, t, d..d+7).
// ---------------------------------------------------------------------------

struct QkvArgs {
    const float* s[3];
    const float* b[3];
    __nv_bfloat16* out[3];
};

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS_HOPPER, 2) qkv_rope_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_wq,
    const __grid_constant__ CUtensorMap tm_wk, const __grid_constant__ CUtensorMap tm_wv,
    const float* __restrict__ sx, const QkvArgs args, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int M, int N, int K, int T, int dh, float q_scale) {
    using C = GemmCfg<BN>;
    extern __shared__ __align__(1024) uint8_t dyn_smem[];
    const GemmRing<BN> ring(dyn_smem);
    const int z = blockIdx.z;
    const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * BN;
    gemm_setup<BN>(ring, args.s[z], args.b[z], n0);
    const CUtensorMap* tm_w = z == 0 ? &tm_wq : z == 1 ? &tm_wk : &tm_wv;
    if (!gemm_tile_staged<BN>(&tm_x, tm_w, ring, m0, n0, K)) return;

    __nv_bfloat16* __restrict__ out = args.out[z];
    const int H = N / dh, half = dh / 2;
    const bool rotate = z < 2;
    constexpr int GROUPS = BN / 8;
    for (int idx = threadIdx.x; idx < C::BM * GROUPS; idx += GEMM_CONSUMERS) {
        const int r = idx / GROUPS, c8 = (idx % GROUPS) * 8;
        const int row = m0 + r;
        if (row >= M) break;
        const int bt = row / T, tt = row % T, col = n0 + c8;
        float y[8];
        staged_row8<BN>(ring, r, c8, sx[row], y);
        if (rotate && col < dh) {
            const size_t rt = (size_t)tt * half + col / 2;
            const float4 c4 = *reinterpret_cast<const float4*>(cos_t + rt);
            const float4 s4 = *reinterpret_cast<const float4*>(sin_t + rt);
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const float y0 = y[2 * p], y1 = y[2 * p + 1];
                y[2 * p] = y0 * cv[p] + (-y1) * sv[p];
                y[2 * p + 1] = y1 * cv[p] + y0 * sv[p];
            }
        }
        if (z == 0 && q_scale != 1.0f) {
#pragma unroll
            for (int e = 0; e < 8; ++e) y[e] *= q_scale;
        }
        const int head = col / dh, d = col % dh;
        store_bf16x8(out + (((long long)bt * H + head) * T + tt) * dh + d, y);
    }
}

// cuTensorMapEncodeTiled of libcuda, found at run time through the CUDA
// runtime (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
    }
    return fn;
}

// A row-major (rows, cols) int8 matrix read in boxes of box_rows x 128 bytes
// with the 128-byte swizzle; cols % 16 == 0.
bool tmap_u8(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
    const EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols};
    const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// once per kernel: its shared memory, and all of the SM's unified memory as
// shared, so that two blocks fit
template <typename Kernel>
void size_smem(Kernel kernel, int bytes, bool& sized) {
    if (sized) return;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    sized = true;
}

template <int BN>
cudaError_t launch_qdense_bn(const int8_t* xq, const float* sx, const int8_t* w, const float* sw, const float* bias,
                             const void* res, const float* gate, const float* mask, void* out, int M, int N, int K,
                             int T, int gelu, int grid_m, Counter c, void* stream) {
    using C = GemmCfg<BN>;
    CUtensorMap tx, tw;
    if (!tmap_u8(&tx, xq, M, K, C::BM) || !tmap_u8(&tw, w, N, K, BN)) return cudaErrorInvalidValue;
    static bool sized = false;
    size_smem(qdense_wgmma_kernel<BN>, C::SMEM, sized);
    qdense_wgmma_kernel<BN><<<dim3(N / BN, grid_m), GEMM_THREADS_HOPPER, C::SMEM, (cudaStream_t)stream>>>(
        tx, tw, sx, sw, bias, (const __nv_bfloat16*)res, gate, mask, (__nv_bfloat16*)out, M, N, K, T, gelu);
    return counted(c);
}

// The one launch site of the s8 GEMM, counted under `c`: K2's (gsv_qdense) or
// K4's (gsv_qdense_out). The wrapper's plan (ops/qmatmul.py gemm_plan) gives
// the tile width (64 or 128) and the row blocks.
cudaError_t launch_qdense(const int8_t* xq, const float* sx, const int8_t* w, const float* sw, const float* bias,
                          const void* res, const float* gate, const float* mask, void* out, int M, int N, int K,
                          int T, int gelu, int tile_n, int grid_m, Counter c, void* stream) {
    if (tile_n == 64)
        return launch_qdense_bn<64>(xq, sx, w, sw, bias, res, gate, mask, out, M, N, K, T, gelu, grid_m, c, stream);
    if (tile_n == 128)
        return launch_qdense_bn<128>(xq, sx, w, sw, bias, res, gate, mask, out, M, N, K, T, gelu, grid_m, c, stream);
    return cudaErrorInvalidValue;
}

template <int BN>
cudaError_t launch_qkv_bn(const int8_t* xq, const float* sx, const int8_t* wq, const int8_t* wk, const int8_t* wv,
                          const QkvArgs& a, const float* cos_t, const float* sin_t, int M, int N, int K, int T,
                          int dh, float q_scale, int grid_m, void* stream) {
    using C = GemmCfg<BN>;
    CUtensorMap tx, tq, tk, tv;
    if (!tmap_u8(&tx, xq, M, K, C::BM) || !tmap_u8(&tq, wq, N, K, BN) || !tmap_u8(&tk, wk, N, K, BN) ||
        !tmap_u8(&tv, wv, N, K, BN))
        return cudaErrorInvalidValue;
    static bool sized = false;
    size_smem(qkv_rope_wgmma_kernel<BN>, C::SMEM, sized);
    qkv_rope_wgmma_kernel<BN><<<dim3(N / BN, grid_m, 3), GEMM_THREADS_HOPPER, C::SMEM, (cudaStream_t)stream>>>(
        tx, tq, tk, tv, sx, a, cos_t, sin_t, M, N, K, T, dh, q_scale);
    return counted(C_QKV);
}

}  // namespace

extern "C" {

// x (M, K) bf16 -> xq (M, K) int8, sx (M) f32; sc/sh (M / T, K) f32 when has_ln.
int gsv_row_quant(const void* x, const float* sc, const float* sh, int8_t* xq, float* sx, int M, int K, int T,
                  int has_ln, void* stream) {
    row_quant_kernel<false><<<M, RQ_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, sc, sh, xq, sx, K, T, has_ln, K);
    return (int)counted(C_ROWQ);
}

// x (M / T, K / dh, T, dh) bf16, heads in -> xq (M, K) int8 with the heads
// merged, sx (M) f32; dh % 8 == 0.
int gsv_row_quant_heads(const void* x, int8_t* xq, float* sx, int M, int K, int T, int dh, void* stream) {
    row_quant_kernel<true><<<M, RQ_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, nullptr, nullptr, xq, sx, K, T, 0, dh);
    return (int)counted(C_ROWQH);
}

// K % 64 == 0, N % tile_n == 0 (tile_n 64 or 128), grid_m = ceil(M / 128).
// res (M, N) bf16 and gate (M / T, N) f32, or both null; mask (M) f32 or
// null; out (M, N) bf16.
int gsv_qdense(const int8_t* xq, const float* sx, const int8_t* w, const float* sw, const float* bias, const void* res,
               const float* gate, const float* mask, void* out, int M, int N, int K, int T, int gelu, int tile_n,
               int grid_m, void* stream) {
    return (int)launch_qdense(xq, sx, w, sw, bias, res, gate, mask, out, M, N, K, T, gelu, tile_n, grid_m, C_QDENSE,
                              stream);
}

// K4's GEMM: gsv_qdense without gelu, on row_quant_heads' codes, counted as
// K4's launch.
int gsv_qdense_out(const int8_t* xq, const float* sx, const int8_t* w, const float* sw, const float* bias,
                   const void* res, const float* gate, const float* mask, void* out, int M, int N, int K, int T,
                   int tile_n, int grid_m, void* stream) {
    return (int)launch_qdense(xq, sx, w, sw, bias, res, gate, mask, out, M, N, K, T, 0, tile_n, grid_m, C_QOUT,
                              stream);
}

// three (N, K) int8 weights; cos/sin (T, dh / 2) f32; q, k, v (M / T, N / dh, T, dh) bf16;
// dh % 8 == 0, N % tile_n == 0 (tile_n 64 or 128), grid_m = ceil(M / 128).
int gsv_qkv_rope(const int8_t* xq, const float* sx, const int8_t* wq, const int8_t* wk, const int8_t* wv,
                 const float* sq, const float* sk, const float* sv, const float* bq, const float* bk, const float* bv,
                 const float* cos_t, const float* sin_t, void* q, void* k, void* v, int M, int N, int K, int T, int dh,
                 float q_scale, int tile_n, int grid_m, void* stream) {
    if (dh % 8 || N % dh) return (int)cudaErrorInvalidValue;
    QkvArgs a;
    a.s[0] = sq; a.s[1] = sk; a.s[2] = sv;
    a.b[0] = bq; a.b[1] = bk; a.b[2] = bv;
    a.out[0] = (__nv_bfloat16*)q; a.out[1] = (__nv_bfloat16*)k; a.out[2] = (__nv_bfloat16*)v;
    if (tile_n == 64)
        return (int)launch_qkv_bn<64>(xq, sx, wq, wk, wv, a, cos_t, sin_t, M, N, K, T, dh, q_scale, grid_m, stream);
    if (tile_n == 128)
        return (int)launch_qkv_bn<128>(xq, sx, wq, wk, wv, a, cos_t, sin_t, M, N, K, T, dh, q_scale, grid_m, stream);
    return (int)cudaErrorInvalidValue;
}

void gsv_qmm_launch_counts(long long* out) {
    for (int i = 0; i < C_COUNT; ++i) out[i] = g_launches[i];
}

void gsv_qmm_reset_launch_counts() {
    for (int i = 0; i < C_COUNT; ++i) g_launches[i] = 0;
}

}  // extern "C"
