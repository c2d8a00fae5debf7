// One-shot-softmax attention with an int8 P@V (K5) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel gpt_sovits_tpu/ops/pallas/qflash.py
// `flash_attn_int8` (body `_qflash_kernel`): non-causal attention of the
// DiT, per (b, head):
//   s  = (q * sm_scale, rounded to bf16) . k^T        bf16 operands, f32 sums
//   s += -1e9 on padded keys (mask (B, T), 0 = pad)
//   e8 = round(exp(s - rowmax(s)) * 127)              int8 in [0, 127]
//   v8 = round(v / sv), sv = max(max_t |v[:, d]| / 127, 1e-8) per column d,
//        over ALL T rows, pad rows included
//   out = (e8 @ v8) * sv / sum(e8)                    s8 x s8 -> s32
// and the heads merged: out (B, T, H * 64) bf16. Any T; dim_head 64; any H.
//
// Two launches: v_quant (the column scales of V and its int8 codes,
// transposed to (B, H, 64, T_pad) so that P@V's B operand is key-contiguous)
// and flash_attn (one block per 64 query rows of one (b, head)). The softmax
// is one-shot as on the TPU: the codes e8 need the row's final max, so the
// block makes two passes over the keys, the first for the max (QK^T only),
// the second recomputing QK^T and accumulating e8 @ v8. The TPU kernel's
// two-heads-per-step layout and its T % block_q restriction have no
// counterpart.
//
// What bounds it: 4 B H T^2 64 operations (half bf16, half int8) against
// ~B H T 64 x 7 bytes; at T = 1024 that is ~600 operations a byte, so the
// floor is the tensor cores' rate (the QK^T half at the bf16 rate).
//
// What the design does about it (an earlier version ran mma.sync from
// 4-byte shared loads with one load stage and no overlap):
//   * flash_attn: a producer warp streams 128-key tiles of K (and, in the
//     second pass, of v8t) by TMA with the 128-byte swizzle into a ring of
//     three slots (mbarriers full/empty), so tile k+1 loads while tile k
//     computes; its lanes write each tile's key biases beside it. One
//     consumer warpgroup owns the block's 64 query rows:
//     QK^T is wgmma m64n128k16 bf16 (q, scaled and rounded once, sits in
//     shared memory as the A operand; the K tile is the K-major B operand);
//     P@V is wgmma m64n64k32 s8 with the e8 tile written to shared memory
//     (double-buffered, swizzled as TMA would) as A and the v8t tile as B.
//     Two blocks fit an SM, so one block's softmax overlaps the other's
//     MMAs; B = 1 launches 256 blocks. QK^T still runs twice (the one-shot
//     softmax needs the final max first): at most 1.5x the operations.
//     What holds it now is the second pass's per-score work (expf, the
//     scale, the rounding, the byte stores: ~17 instructions a score), not
//     the tensor cores; rounding with an add of 1.5 * 2^23 instead of
//     rintf and a conversion took two quarter-rate instructions a score
//     out of it.
//   * v_quant: clusters of 8 blocks per (b, head), each block a share of
//     the 128-key tiles; the column maxima are combined through distributed
//     shared memory, so B = 1 runs 128 blocks, not 16.
//
// Numerics are the twin's: rintf (half to even) on expf(s - max) * 127,
// exact integer row sums, one bf16 rounding of the output.
//
// C interface: each entry returns cudaGetLastError() after its launch (or
// an error without launching when a TMA descriptor cannot be made); every
// launch the runtime accepts adds one to its kernel's count
// (gsv_qflash_launch_counts), at the launch and nowhere else.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Counter { C_VQUANT, C_FLASH, C_COUNT };
long long g_launches[C_COUNT] = {};

cudaError_t counted(Counter c) {
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++g_launches[c];
    return e;
}

constexpr float INV127 = (float)(1.0 / 127.0);
constexpr int DH = 64;   // head width
constexpr int QB = 64;   // query rows per block: one warpgroup's wgmma M
constexpr int KB = 128;  // keys per tile; v8t is padded to a multiple of it

// ---------------------------------------------------------------------------
// v_quant: a cluster of VQ_CLUSTER blocks per (b, head); block r takes the
// 128-key tiles r, r + 8, ... sv[d] over all T rows; v8t (64, T_pad) int8
// with zeros beyond T.
// ---------------------------------------------------------------------------

constexpr int VQ_CLUSTER = 8;
constexpr int VQ_THREADS = 256;

__global__ void __cluster_dims__(VQ_CLUSTER, 1, 1) __launch_bounds__(VQ_THREADS)
    v_quant_kernel(const __nv_bfloat16* __restrict__ v, int8_t* __restrict__ v8t, float* __restrict__ sv_out, int T,
                   int T_pad) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    __shared__ float red[32][DH + 1];
    __shared__ float colmax[DH];
    __shared__ float inv_s[DH];
    __shared__ __align__(16) int8_t tile[DH][KB + 16];
    const int rank = (int)cluster.block_rank();
    const long long bh = blockIdx.y;
    const __nv_bfloat16* vb = v + bh * T * DH;
    const int n_tiles = T_pad / KB;
    const int tid = threadIdx.x;

    // the column maxima of |v| over this block's rows: 8 columns a thread
    {
        const int r = tid >> 3, c = (tid & 7) * 8;
        float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int tl = rank; tl < n_tiles; tl += VQ_CLUSTER) {
            const int end = min(tl * KB + KB, T);
            for (int t = tl * KB + r; t < end; t += 32) {
                const uint4 raw = *reinterpret_cast<const uint4*>(vb + (long long)t * DH + c);
                const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float2 f = __bfloat1622float2(p[j]);
                    m[2 * j] = fmaxf(m[2 * j], fabsf(f.x));
                    m[2 * j + 1] = fmaxf(m[2 * j + 1], fabsf(f.y));
                }
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) red[r][c + j] = m[j];
    }
    __syncthreads();
    if (tid < DH) {
        float m = 0.f;
        for (int r = 0; r < 32; ++r) m = fmaxf(m, red[r][tid]);
        colmax[tid] = m;
    }
    cluster.sync();  // every block's colmax is written
    if (tid < DH) {
        float m = 0.f;
        for (int rk = 0; rk < VQ_CLUSTER; ++rk) m = fmaxf(m, cluster.map_shared_rank(colmax, rk)[tid]);
        const float s = fmaxf(m * INV127, 1e-8f);
        inv_s[tid] = 1.0f / s;
        if (rank == 0) sv_out[bh * DH + tid] = s;
    }
    cluster.sync();  // no block leaves while another reads its colmax

    // the codes of this block's tiles, transposed through shared memory
    int8_t* out = v8t + bh * DH * (long long)T_pad;
    const int tt = tid & (KB - 1), d0 = (tid >> 7) * 32;
    for (int tl = rank; tl < n_tiles; tl += VQ_CLUSTER) {
        const int t = tl * KB + tt;
        uint4 raw[4] = {};
        if (t < T) {
#pragma unroll
            for (int j = 0; j < 4; ++j) raw[j] = *reinterpret_cast<const uint4*>(vb + (long long)t * DH + d0 + 8 * j);
        }
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(raw);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const float2 f = __bfloat1622float2(p[j]);
            const int d = d0 + 2 * j;
            tile[d][tt] = (int8_t)fminf(fmaxf(rintf(f.x * inv_s[d]), -127.f), 127.f);
            tile[d + 1][tt] = (int8_t)fminf(fmaxf(rintf(f.y * inv_s[d + 1]), -127.f), 127.f);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // 64 rows of 128 bytes: two 16-byte stores a thread
            const int idx = tid + i * VQ_THREADS, row = idx >> 3, ch = idx & 7;
            *reinterpret_cast<uint4*>(out + (long long)row * T_pad + tl * KB + ch * 16) =
                *reinterpret_cast<const uint4*>(&tile[row][ch * 16]);
        }
        __syncthreads();
    }
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

// Generic-proxy shared stores made visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A box of the 3-D tensor map at (c0 innermost, c1, c2) into shared memory;
// completion is counted in bytes on `bar`. Out-of-bounds elements are zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
        "[%5];\n"
        :
        : "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving accumulator accesses across wgmma's
// asynchronous reads and writes of them.
template <int R>
__device__ __forceinline__ void reg_fence(int (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a K-major tile whose rows are 128 bytes, stored as TMA's
// 128-byte swizzle writes it (8-row atoms of 1024 bytes, 1024-byte aligned).
// Advancing the start address by 32 bytes steps k by one wgmma.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
           ((uint64_t)1 << 62);
}

// Byte offset of (row, byte col) in such a tile.
__device__ __forceinline__ int sw128_offset(int row, int col) {
    return row * 128 + ((((col >> 4) ^ (row & 7)) << 4) | (col & 15));
}

// D (64 x 128, f32) = / += A (64 x 16, bf16, shared) . B (128 x 16, bf16, shared)^T
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}
// D (64 x 64, s32) += A (64 x 32, s8, shared) . B (64 x 32, s8, shared)^T
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

// ---------------------------------------------------------------------------
// flash_attn
// ---------------------------------------------------------------------------

constexpr int FA_STAGES = 3;
constexpr int K_BYTES = KB * DH * 2;  // a K tile: 128 keys x 128 bytes
constexpr int V_BYTES = DH * KB;      // a v8t tile: 64 columns x 128 keys
constexpr int Q_BYTES = QB * DH * 2;
constexpr int P_BYTES = QB * KB;      // an e8 tile: 64 rows x 128 keys
constexpr int FA_CONSUMERS = 128;     // one warpgroup
constexpr int FA_THREADS = FA_CONSUMERS + 32;  // and the producer warp
constexpr int BIAS_BYTES = KB * 4;   // a tile's key biases, f32
constexpr int FA_SMEM =
    1024 + FA_STAGES * (K_BYTES + V_BYTES + BIAS_BYTES) + Q_BYTES + 2 * P_BYTES + 2 * FA_STAGES * 8;

// 0 on a real key, -1e9 on a pad key, -inf beyond T (a zero-filled row of the last tile)
__device__ __forceinline__ float key_bias(const float* maskb, int key, int T) {
    if (key >= T) return -INFINITY;
    return (maskb == nullptr || maskb[key] > 0.f) ? 0.f : -1e9f;
}

// e8 = rint(expf(x) * 127) for x <= 0, in the low byte of the result, whose
// other bits are E8_BIAS: adding 1.5 * 2^23 rounds the scaled value half to
// even, as rintf does, without the conversion unit (rintf and a float-to-int
// conversion each take a quarter-rate instruction per score). __fmul_rn and
// __fadd_rn keep nvcc from fusing the scale into the add.
constexpr float E8_MAGIC = 12582912.0f;  // 1.5 * 2^23
constexpr uint32_t E8_BIAS = 0x4B400000u;  // its bits
__device__ __forceinline__ uint32_t e8_bits(float x) {
    return __float_as_uint(__fadd_rn(__fmul_rn(expf(x), 127.0f), E8_MAGIC));
}

// The warpgroup's 64 x 128 scores of one key tile, f32.
__device__ __forceinline__ void tile_scores(float (&s)[64], const uint8_t* sq, const uint8_t* k_tile) {
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int k = 0; k < DH * 2 / 32; ++k) wgmma_bf16_n128(s, sw128_desc(sq + 32 * k), sw128_desc(k_tile + 32 * k), k);
    wg_commit();
    wg_wait0();
    reg_fence(s);
}

__global__ void __launch_bounds__(FA_THREADS, 2) flash_attn_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const __nv_bfloat16* __restrict__ q, const float* __restrict__ sv, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int H, int T, float sm_scale) {
    extern __shared__ __align__(1024) uint8_t dyn_smem[];
    uint8_t* smem = dyn_smem + ((1024 - (smem_u32(dyn_smem) & 1023)) & 1023);
    uint8_t* sk = smem;
    uint8_t* svt = sk + FA_STAGES * K_BYTES;
    uint8_t* sq = svt + FA_STAGES * V_BYTES;
    uint8_t* sp = sq + Q_BYTES;
    float* sbias = reinterpret_cast<float*>(sp + 2 * P_BYTES);
    uint64_t* full = reinterpret_cast<uint64_t*>(sbias + FA_STAGES * KB);
    uint64_t* empty = full + FA_STAGES;
    const int q0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
    const int bh = b * H + h;
    const int n_tiles = (T + KB - 1) / KB;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < FA_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], FA_CONSUMERS);
        }
        fence_barrier_init();
    }
    __syncthreads();

    // The key tiles in order: pass 1 (K) then pass 2 (K and v8t), one slot
    // each, with the tile's key biases written by the warp's lanes.
    if (tid >= FA_CONSUMERS) {  // the producer warp
        const int lane = tid & 31;
        const float* maskb = mask == nullptr ? nullptr : mask + (long long)b * T;
        for (int it = 0; it < 2 * n_tiles; ++it) {
            const int s = it % FA_STAGES;
            const bool second = it >= n_tiles;
            const int j0 = (second ? it - n_tiles : it) * KB;
            mbar_wait(&empty[s], ((it / FA_STAGES) & 1) ^ 1);
#pragma unroll
            for (int c = lane; c < KB; c += 32) sbias[s * KB + c] = key_bias(maskb, j0 + c, T);
            __syncwarp();  // the arrival below releases every lane's biases
            if (lane == 0) {
                mbar_expect_tx(&full[s], second ? K_BYTES + V_BYTES : K_BYTES);
                tma_load_3d(sk + s * K_BYTES, &tm_k, 0, j0, bh, &full[s]);
                if (second) tma_load_3d(svt + s * V_BYTES, &tm_v, j0, 0, bh, &full[s]);
            }
        }
        return;
    }

    // q * bf16(sm_scale), rounded to bf16, into the swizzled A tile; rows past T are zeros
    {
        const float scale = __bfloat162float(__float2bfloat16_rn(sm_scale));
        const __nv_bfloat16* qb = q + (long long)bh * T * DH;
        for (int c = tid; c < QB * (DH / 8); c += FA_CONSUMERS) {
            const int r = c >> 3, ch = c & 7;
            uint4 raw = make_uint4(0u, 0u, 0u, 0u);
            if (q0 + r < T) raw = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * DH + ch * 8);
            __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(p[j]);
                p[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
            }
            *reinterpret_cast<uint4*>(sq + sw128_offset(r, ch * 16)) = raw;
        }
    }
    fence_proxy_async();
    named_sync(1, FA_CONSUMERS);

    // this thread's fragments: rows ra and ra + 8 of the tile, keys (or
    // columns) 8 jj + 2 qd + {0, 1} of each group jj of eight
    const int warp = tid >> 5, lane = tid & 31, qd = lane & 3;
    const int ra = warp * 16 + (lane >> 2);
    float s[64];
    int o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0;
    float m0 = -INFINITY, m1 = -INFINITY;
    uint32_t rs0 = 0, rs1 = 0;
#pragma unroll 1
    for (int it = 0; it < 2 * n_tiles; ++it) {
        const int st = it % FA_STAGES;
        const bool second = it >= n_tiles;
        mbar_wait(&full[st], (it / FA_STAGES) & 1);
        const uint8_t* k_tile = sk + st * K_BYTES;
        const float* bias = sbias + st * KB;
        tile_scores(s, sq, k_tile);
        if (!second) {  // pass 1: the row max over every key
#pragma unroll
            for (int jj = 0; jj < KB / 8; ++jj) {
                const float2 bb = *reinterpret_cast<const float2*>(bias + jj * 8 + 2 * qd);
                m0 = fmaxf(m0, fmaxf(s[4 * jj] + bb.x, s[4 * jj + 1] + bb.y));
                m1 = fmaxf(m1, fmaxf(s[4 * jj + 2] + bb.x, s[4 * jj + 3] + bb.y));
            }
            mbar_arrive(&empty[st]);
            if (it == n_tiles - 1) {
#pragma unroll
                for (int x = 1; x < 4; x <<= 1) {
                    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
                    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
                }
            }
            continue;
        }
        // pass 2: e8 = round(exp(s - max) * 127) into the e8 tile, row sums, e8 @ v8
        uint8_t* p_tile = sp + ((it - n_tiles) & 1) * P_BYTES;
#pragma unroll
        for (int jj = 0; jj < KB / 8; ++jj) {
            const int col = jj * 8 + 2 * qd;
            const float2 bb = *reinterpret_cast<const float2*>(bias + col);
            const uint32_t e0 = e8_bits(s[4 * jj] + bb.x - m0), e1 = e8_bits(s[4 * jj + 1] + bb.y - m0);
            const uint32_t e2 = e8_bits(s[4 * jj + 2] + bb.x - m1), e3 = e8_bits(s[4 * jj + 3] + bb.y - m1);
            rs0 += e0 + e1;
            rs1 += e2 + e3;
            *reinterpret_cast<uint16_t*>(p_tile + sw128_offset(ra, col)) = (uint16_t)__byte_perm(e0, e1, 0x0040);
            *reinterpret_cast<uint16_t*>(p_tile + sw128_offset(ra + 8, col)) = (uint16_t)__byte_perm(e2, e3, 0x0040);
        }
        fence_proxy_async();
        named_sync(1, FA_CONSUMERS);  // the whole e8 tile is written
        const uint8_t* v_tile = svt + st * V_BYTES;
        reg_fence(o);
        wg_fence();
#pragma unroll
        for (int k = 0; k < KB / 32; ++k) wgmma_s8_n64(o, sw128_desc(p_tile + 32 * k), sw128_desc(v_tile + 32 * k), 1);
        wg_commit();
        wg_wait0();
        reg_fence(o);
        mbar_arrive(&empty[st]);
    }

    // each of the thread's 32 x n_tiles codes of a row carried E8_BIAS (sums mod 2^32)
    rs0 -= 32u * n_tiles * E8_BIAS;
    rs1 -= 32u * n_tiles * E8_BIAS;
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, x);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, x);
    }
    const float inv0 = 1.0f / (float)(int)rs0, inv1 = 1.0f / (float)(int)rs1;
    const float* svb = sv + (long long)bh * DH;
    const int row0 = q0 + ra, row1 = row0 + 8;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
        const int d = dn * 8 + 2 * qd;
        const float s0 = svb[d], s1 = svb[d + 1];
        if (row0 < T) {
            __nv_bfloat16* op = out + (((long long)b * T + row0) * H + h) * DH + d;
            *reinterpret_cast<__nv_bfloat162*>(op) =
                __floats2bfloat162_rn((float)o[4 * dn] * s0 * inv0, (float)o[4 * dn + 1] * s1 * inv0);
        }
        if (row1 < T) {
            __nv_bfloat16* op = out + (((long long)b * T + row1) * H + h) * DH + d;
            *reinterpret_cast<__nv_bfloat162*>(op) =
                __floats2bfloat162_rn((float)o[4 * dn + 2] * s0 * inv1, (float)o[4 * dn + 3] * s1 * inv1);
        }
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

// A (d2, d1, d0) tensor, d0 innermost, read in boxes of (1, box1, box0)
// elements with the 128-byte swizzle (box0 elements are 128 bytes).
bool tmap_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int d0, int d1, int d2, long long row_bytes,
             int box0, int box1) {
    const EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
    const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)(row_bytes * d1)};
    const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return enc(map, type, 3, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// v (B*H, T, 64) bf16 -> v8t (B*H, 64, T_pad) int8, sv (B*H, 64) f32; T_pad % 128 == 0.
int gsv_v_quant(const void* v, int8_t* v8t, float* sv, int BH, int T, int T_pad, void* stream) {
    v_quant_kernel<<<dim3(VQ_CLUSTER, BH), VQ_THREADS, 0, (cudaStream_t)stream>>>((const __nv_bfloat16*)v, v8t, sv, T,
                                                                                 T_pad);
    return (int)counted(C_VQUANT);
}

// q, k (B, H, T, 64) bf16; v8t (B*H, 64, T_pad) int8; mask (B, T) f32 or
// null; out (B, T, H*64) bf16.
int gsv_flash_attn(const void* q, const void* k, const int8_t* v8t, const float* sv, const float* mask, void* out,
                   int B, int H, int T, int T_pad, float sm_scale, void* stream) {
    CUtensorMap tk, tv;
    if (!tmap_3d(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, DH, T, B * H, DH * 2, DH, KB) ||
        !tmap_3d(&tv, CU_TENSOR_MAP_DATA_TYPE_UINT8, v8t, T_pad, DH, B * H, T_pad, KB, DH))
        return (int)cudaErrorInvalidValue;
    static bool sized = false;
    if (!sized) {  // and all of the SM's unified memory as shared, so that two blocks fit
        cudaFuncSetAttribute(flash_attn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FA_SMEM);
        cudaFuncSetAttribute(flash_attn_wgmma_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
        sized = true;
    }
    const dim3 grid((T + QB - 1) / QB, H, B);
    flash_attn_wgmma_kernel<<<grid, FA_THREADS, FA_SMEM, (cudaStream_t)stream>>>(
        tk, tv, (const __nv_bfloat16*)q, sv, mask, (__nv_bfloat16*)out, H, T, sm_scale);
    return (int)counted(C_FLASH);
}

void gsv_qflash_launch_counts(long long* out) {
    for (int i = 0; i < C_COUNT; ++i) out[i] = g_launches[i];
}

void gsv_qflash_reset_launch_counts() {
    for (int i = 0; i < C_COUNT; ++i) g_launches[i] = 0;
}

}  // extern "C"
