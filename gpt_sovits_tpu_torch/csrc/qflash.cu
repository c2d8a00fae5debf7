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
// and flash_attn (one block per 64 query rows of one (b, head); four warps
// of 16 rows). The softmax is one-shot as on the TPU: the codes e8 need the
// row's final max, so the block makes two passes over the keys, the first
// for the max (QK^T only), the second recomputing QK^T and accumulating
// e8 @ v8 with mma.sync m16n8k32 s8. The TPU kernel's two-heads-per-step
// layout and its T % block_q restriction have no counterpart.
//
// What bounds it: 4 B H T^2 64 operations (half bf16, half int8) against
// ~B H T 64 x 7 bytes; at T = 1024 that is ~600 operations a byte, so the
// floor is the tensor cores' rate (the QK^T half at the bf16 rate). This
// version computes QK^T twice and runs mma.sync from shared tiles without
// double buffering; PERF.md records how far it is from the floor.
//
// C interface: each entry returns cudaGetLastError() after its launch;
// every launch the runtime accepts adds one to its kernel's count
// (gsv_qflash_launch_counts), at the launch and nowhere else.

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
constexpr int DH = 64;     // head width
constexpr int QB = 64;     // query rows per block
constexpr int KB = 64;     // keys per tile
constexpr int KLD = DH + 8;  // bf16 per shared K/Q row: 144 bytes, conflict-free fragment loads
constexpr int VLD = KB + 16;  // bytes per shared int8 row: 80
constexpr int FA_THREADS = 128;

// ---------------------------------------------------------------------------
// v_quant: one block per (b, head). sv[d] over all T rows; v8t (64, T_pad)
// int8 with zeros beyond T.
// ---------------------------------------------------------------------------

constexpr int VQ_THREADS = 256;

__global__ void __launch_bounds__(VQ_THREADS) v_quant_kernel(const __nv_bfloat16* __restrict__ v,
                                                             int8_t* __restrict__ v8t, float* __restrict__ sv_out,
                                                             int T, int T_pad) {
    __shared__ float red[VQ_THREADS / DH][DH];
    __shared__ float inv_s[DH];
    __shared__ __align__(16) int8_t tile[DH][KB + 4];
    const long long bh = blockIdx.x;
    const __nv_bfloat16* vb = v + bh * T * DH;
    const int d = threadIdx.x & (DH - 1), r0 = threadIdx.x / DH;
    constexpr int RG = VQ_THREADS / DH;  // row groups: 4
    float m = 0.f;
    for (int t = r0; t < T; t += RG) m = fmaxf(m, fabsf(__bfloat162float(vb[(long long)t * DH + d])));
    red[r0][d] = m;
    __syncthreads();
    if (r0 == 0) {
        for (int r = 1; r < RG; ++r) m = fmaxf(m, red[r][d]);
        const float s = fmaxf(m * INV127, 1e-8f);
        sv_out[bh * DH + d] = s;
        inv_s[d] = 1.0f / s;
    }
    __syncthreads();
    const float inv = inv_s[d];
    int8_t* out = v8t + bh * DH * (long long)T_pad;
    for (int t0 = 0; t0 < T_pad; t0 += KB) {
        for (int tt = r0; tt < KB; tt += RG) {
            const int t = t0 + tt;
            float q = 0.f;
            if (t < T) q = fminf(fmaxf(rintf(__bfloat162float(vb[(long long)t * DH + d]) * inv), -127.f), 127.f);
            tile[d][tt] = (int8_t)q;
        }
        __syncthreads();
        // 64 rows of 64 bytes: one 16-byte store per thread
        const int row = threadIdx.x >> 2, chunk = threadIdx.x & 3;
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const uint32_t*>(&tile[row][chunk * 16 + j * 4]);
        *reinterpret_cast<uint4*>(out + (long long)row * T_pad + t0 + chunk * 16) = make_uint4(w[0], w[1], w[2], w[3]);
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// flash_attn
// ---------------------------------------------------------------------------

struct FlashSmem {
    __nv_bfloat16 q[QB][KLD];
    __nv_bfloat16 k[KB][KLD];
    int8_t v[DH][VLD];
    int8_t p[FA_THREADS / 32][16][VLD];  // each warp's e8 tile (16 rows x 64 keys)
    float bias[KB];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <class P>
__device__ __forceinline__ unsigned lds32(const P* p) {
    return *reinterpret_cast<const unsigned*>(p);
}

// K tile (keys j0.., zeros beyond T) and the key bias (0, -1e9 on pads,
// -inf beyond T) into shared memory.
__device__ __forceinline__ void load_keys(FlashSmem& sm, const __nv_bfloat16* kb, const float* maskb, int j0, int T) {
    for (int c = threadIdx.x; c < KB * (DH / 8); c += FA_THREADS) {
        const int r = c >> 3, col = (c & 7) * 8;
        const bool ok = j0 + r < T;
        cp_async16(&sm.k[r][col], kb + (long long)(ok ? j0 + r : 0) * DH + col, ok);
    }
    if (threadIdx.x < KB) {
        const int j = j0 + threadIdx.x;
        float bv = -INFINITY;
        if (j < T) bv = (maskb == nullptr || maskb[j] > 0.f) ? 0.f : -1e9f;
        sm.bias[threadIdx.x] = bv;
    }
}

// The warp's 16 x 64 scores of the current key tile (f32, bias added);
// sc[nt][0..1] row g, sc[nt][2..3] row g + 8, keys nt*8 + 2t + {0, 1}.
__device__ __forceinline__ void tile_scores(const FlashSmem& sm, const unsigned (&qa)[4][4], float (&sc)[8][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            unsigned kb[2];
            kb[0] = lds32(&sm.k[nt * 8 + g][ks * 16 + 2 * t]);
            kb[1] = lds32(&sm.k[nt * 8 + g][ks * 16 + 8 + 2 * t]);
            mma_bf16(sc[nt], qa[ks], kb);
        }
        const float b0 = sm.bias[nt * 8 + 2 * t], b1 = sm.bias[nt * 8 + 2 * t + 1];
        sc[nt][0] += b0;
        sc[nt][1] += b1;
        sc[nt][2] += b0;
        sc[nt][3] += b1;
    }
}

__global__ void __launch_bounds__(FA_THREADS) flash_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const int8_t* __restrict__ v8t,
    const float* __restrict__ sv, const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int H, int T,
    int T_pad, float sm_scale) {
    __shared__ __align__(16) FlashSmem sm;
    const int q0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
    const long long bh = (long long)b * H + h;
    const __nv_bfloat16* qb = q + bh * T * DH;
    const __nv_bfloat16* kb = k + bh * T * DH;
    const int8_t* vb = v8t + bh * DH * (long long)T_pad;
    const float* maskb = mask == nullptr ? nullptr : mask + (long long)b * T;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

    // q tile, scaled by sm_scale in bf16 (q * bf16(sm_scale), rounded to bf16)
    const float scale = __bfloat162float(__float2bfloat16_rn(sm_scale));
    for (int c = threadIdx.x; c < QB * (DH / 8); c += FA_THREADS) {
        const int r = c >> 3, col = (c & 7) * 8;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < T) raw = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * DH + col);
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(p[j]);
            p[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
        *reinterpret_cast<uint4*>(&sm.q[r][col]) = raw;
    }
    __syncthreads();
    unsigned qa[4][4];
    const int qr = warp * 16 + g;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
        qa[ks][0] = lds32(&sm.q[qr][ks * 16 + 2 * t]);
        qa[ks][1] = lds32(&sm.q[qr + 8][ks * 16 + 2 * t]);
        qa[ks][2] = lds32(&sm.q[qr][ks * 16 + 8 + 2 * t]);
        qa[ks][3] = lds32(&sm.q[qr + 8][ks * 16 + 8 + 2 * t]);
    }

    // pass 1: the row max over every key
    float m0 = -INFINITY, m1 = -INFINITY;
    float sc[8][4];
    for (int j0 = 0; j0 < T; j0 += KB) {
        load_keys(sm, kb, maskb, j0, T);
        cp_async_wait_all();
        __syncthreads();
        tile_scores(sm, qa, sc);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            m0 = fmaxf(m0, fmaxf(sc[nt][0], sc[nt][1]));
            m1 = fmaxf(m1, fmaxf(sc[nt][2], sc[nt][3]));
        }
        __syncthreads();
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }

    // pass 2: e8 = round(exp(s - max) * 127), e8 @ v8, row sums of e8
    int acc[8][4];
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0;
    int rs0 = 0, rs1 = 0;
    int8_t(*pw)[VLD] = sm.p[warp];
    for (int j0 = 0; j0 < T; j0 += KB) {
        load_keys(sm, kb, maskb, j0, T);
        for (int c = threadIdx.x; c < DH * (KB / 16); c += FA_THREADS) {
            const int r = c >> 2, col = (c & 3) * 16;
            cp_async16(&sm.v[r][col], vb + (long long)r * T_pad + j0 + col, true);
        }
        cp_async_wait_all();
        __syncthreads();
        tile_scores(sm, qa, sc);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int e0 = (int)rintf(expf(sc[nt][0] - m0) * 127.0f);
            const int e1 = (int)rintf(expf(sc[nt][1] - m0) * 127.0f);
            const int e2 = (int)rintf(expf(sc[nt][2] - m1) * 127.0f);
            const int e3 = (int)rintf(expf(sc[nt][3] - m1) * 127.0f);
            rs0 += e0 + e1;
            rs1 += e2 + e3;
            const int col = nt * 8 + 2 * t;
            *reinterpret_cast<char2*>(&pw[g][col]) = make_char2((signed char)e0, (signed char)e1);
            *reinterpret_cast<char2*>(&pw[g + 8][col]) = make_char2((signed char)e2, (signed char)e3);
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < KB; kk += 32) {
            unsigned a[4];
            a[0] = lds32(&pw[g][kk + 4 * t]);
            a[1] = lds32(&pw[g + 8][kk + 4 * t]);
            a[2] = lds32(&pw[g][kk + 16 + 4 * t]);
            a[3] = lds32(&pw[g + 8][kk + 16 + 4 * t]);
#pragma unroll
            for (int dn = 0; dn < 8; ++dn) {
                unsigned bb[2];
                bb[0] = lds32(&sm.v[dn * 8 + g][kk + 4 * t]);
                bb[1] = lds32(&sm.v[dn * 8 + g][kk + 16 + 4 * t]);
                mma_s8(acc[dn], a, bb);
            }
        }
        __syncthreads();  // the next tile overwrites k, v, bias and each warp's p
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
    }
    const float inv0 = 1.0f / (float)rs0, inv1 = 1.0f / (float)rs1;
    const float* svb = sv + bh * DH;
    const int row0 = q0 + qr, row1 = row0 + 8;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
        const int d = dn * 8 + 2 * t;
        const float s0 = svb[d], s1 = svb[d + 1];
        if (row0 < T) {
            __nv_bfloat16* o = out + (((long long)b * T + row0) * H + h) * DH + d;
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn((float)acc[dn][0] * s0 * inv0, (float)acc[dn][1] * s1 * inv0);
        }
        if (row1 < T) {
            __nv_bfloat16* o = out + (((long long)b * T + row1) * H + h) * DH + d;
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn((float)acc[dn][2] * s0 * inv1, (float)acc[dn][3] * s1 * inv1);
        }
    }
}

}  // namespace

extern "C" {

// v (B*H, T, 64) bf16 -> v8t (B*H, 64, T_pad) int8, sv (B*H, 64) f32; T_pad % 64 == 0.
int gsv_v_quant(const void* v, int8_t* v8t, float* sv, int BH, int T, int T_pad, void* stream) {
    v_quant_kernel<<<BH, VQ_THREADS, 0, (cudaStream_t)stream>>>((const __nv_bfloat16*)v, v8t, sv, T, T_pad);
    return (int)counted(C_VQUANT);
}

// q, k (B, H, T, 64) bf16; mask (B, T) f32 or null; out (B, T, H*64) bf16.
int gsv_flash_attn(const void* q, const void* k, const int8_t* v8t, const float* sv, const float* mask, void* out,
                   int B, int H, int T, int T_pad, float sm_scale, void* stream) {
    const dim3 grid((T + QB - 1) / QB, H, B);
    flash_attn_kernel<<<grid, FA_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, v8t, sv, mask, (__nv_bfloat16*)out, H, T, T_pad, sm_scale);
    return (int)counted(C_FLASH);
}

void gsv_qflash_launch_counts(long long* out) {
    for (int i = 0; i < C_COUNT; ++i) out[i] = g_launches[i];
}

void gsv_qflash_reset_launch_counts() {
    for (int i = 0; i < C_COUNT; ++i) g_launches[i] = 0;
}

}  // extern "C"
