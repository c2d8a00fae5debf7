// S1 decode step (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel gpt_sovits_tpu/ops/pallas/decode_step.py
// `fused_decode_step` (kernel body `_make_kernel`): one token step through
// all L post-LN transformer layers of the S1 model, for B <= 8 rows.
//
// What bounds it: the step reads every layer's weights once (75.5 M values
// at full width: 151 MB in bf16, 75.5 MB in int8) plus the live KV prefix of
// each row (L x live x 2 KB in bf16, half that in int8). At B <= 8 that is
// a few FLOPs per byte, far below the card's ~300 FLOP/byte ridge, so the
// floor is bytes over memory bandwidth.
//
// What the design does about it: the step is one persistent launch
// (step::step_kernel, called once per token by gsv_decode_step, at the end
// of the file), the structure of the TPU kernel itself. 128 co-resident
// blocks run the 24 layers, five phases a layer between grid barriers; each
// block owns fixed 16-column slices of the projections and streams every
// layer's slices into shared memory by 1-D TMA while it runs the layer
// before, so the weight bytes overlap the barriers; the products run on
// tensor cores (mma.sync, the B <= 8 rows in the n = 8 slot). The note
// above step::step_kernel has the details. Three kernels of one projection,
// attention or LayerNorm each (gsv_proj, gsv_decode_attn,
// gsv_add_layernorm, below) stay callable on their own and are held against
// their twins; the step launches none of them. proj reads W in 16- or
// 8-byte vectors with several loads in flight per lane and splits K across
// blocks; decode_attn reads the live KV prefix once per (row, head) in
// flash-decoding splits.
//
// Numerics follow the TPU kernel:
//   * bf16 mode: bf16 operands, f32 accumulation; probabilities cast to bf16
//     before P@V.
//   * W8A8: per-row activation scale xs = max(max|x|, 1e-6) / 127,
//     round-half-even(x * (1 / xs)) clipped to +-127, s8 x s8 -> s32, then
//     * xs * w_scale[n].
//   * int8 KV: q quantized per head, scores rescaled by the K scales, probs
//     multiplied by the V scales and quantized per head per split (the TPU
//     kernel quantizes per VMEM chunk, so the two agree to rounding only);
//     the new token's K and V are quantized per token, as the wrapper of
//     the TPU kernel does after it.
//   * LayerNorm eps 1e-5; rounding uses rintf / round-to-nearest-even.
//
// C interface: each entry returns cudaGetLastError() after its launches.
// Every launch that the runtime accepts adds one to its kernel's count
// (gsv_launch_counts), at the launch and nowhere else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;

// launch counts, in the order gsv_launch_counts reports them
enum Counter { C_PROJ, C_ATTN, C_LN, C_STEP, C_COUNT };
long long g_launches[C_COUNT] = {};

// the error of the launch just made; counts it if the runtime took it
cudaError_t counted(Counter c) {
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++g_launches[c];
    return e;
}

// ---------------------------------------------------------------------------
// proj: y[b, n] = sum_k x[b, k] * W[k, n] + bias[n]  (optional ReLU)
//
// A block owns a tile of 64 output columns and a chunk of K (split-K, so
// that each projection of the main path spreads over 32-128 blocks). Each lane
// owns 8 adjacent columns and reads them with one 16-byte (bf16) or 8-byte
// (int8) load per W row; 8 lanes cover a row's tile, so a warp reads 4 rows
// at a time. All PROJ_UNROLL loads of a lane are issued before any of them
// is used, which keeps ~16 KB of W in flight per block whatever B is. The
// split-K partial tiles go to scratch; the last block of a column tile to
// finish (an atomic ticket per tile) sums them in split order, so the
// result does not depend on which block finishes first.
// ---------------------------------------------------------------------------

constexpr int PROJ_TILE = 64;                              // output columns per block
constexpr int PROJ_VEC = 8;                                // columns per lane
constexpr int PROJ_ROW_LANES = PROJ_TILE / PROJ_VEC;       // lanes per W row: 8
constexpr int PROJ_WARP_ROWS = 32 / PROJ_ROW_LANES;        // W rows per warp load: 4
constexpr int PROJ_WARPS = 8;
constexpr int PROJ_THREADS = PROJ_WARPS * 32;
constexpr int PROJ_UNROLL = 4;
constexpr int PROJ_ITER_ROWS = PROJ_WARPS * PROJ_WARP_ROWS * PROJ_UNROLL;  // 128

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// 8 columns of one W row: 8 bf16 in a uint4, or 8 int8 in a uint2
template <bool INT8>
struct WVec;
template <>
struct WVec<false> {
    using T = uint4;
    __device__ static void unpack(const uint4& v, float (&w)[PROJ_VEC]) {
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
            w[2 * i] = f.x;
            w[2 * i + 1] = f.y;
        }
    }
};
template <>
struct WVec<true> {
    using T = uint2;
    __device__ static void unpack(const uint2& v, int (&w)[PROJ_VEC]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            w[i] = static_cast<int>(static_cast<int8_t>((v.x >> (8 * i)) & 0xffu));
            w[4 + i] = static_cast<int>(static_cast<int8_t>((v.y >> (8 * i)) & 0xffu));
        }
    }
};

template <int B, bool INT8>
__global__ void __launch_bounds__(PROJ_THREADS) proj_kernel(
    const float* __restrict__ x, const void* __restrict__ w, const float* __restrict__ w_scale,
    const float* __restrict__ bias, float* __restrict__ y, void* __restrict__ part, int* __restrict__ tickets,
    int K, int N, int k_chunk, int relu) {
    using Acc = std::conditional_t<INT8, int, float>;
    using Op = std::conditional_t<INT8, int8_t, __nv_bfloat16>;
    using V = typename WVec<INT8>::T;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float row_scale[B];
    __shared__ int is_last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tile = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
    const int n0 = tile * PROJ_TILE, k0 = split * k_chunk;
    const int cl = lane % PROJ_ROW_LANES, rl = lane / PROJ_ROW_LANES;

    // stage this block's K chunk of the B rows in the operand type
    Op* xs = reinterpret_cast<Op*>(smem);
    if constexpr (INT8) {
        if (warp < B) {  // the activation scale spans the whole row
            float amax = 0.f;
#pragma unroll 8
            for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(x[warp * K + k]));
            amax = warp_max(amax);
            if (lane == 0) row_scale[warp] = fmaxf(amax, 1e-6f) * (1.0f / 127.0f);
        }
        __syncthreads();
    }
    for (int i = tid; i < B * k_chunk; i += PROJ_THREADS) {
        const int b = i / k_chunk;
        const float v = x[b * K + k0 + i % k_chunk];
        if constexpr (INT8) {
            const float inv = 1.0f / row_scale[b];
            xs[i] = static_cast<int8_t>(fminf(fmaxf(rintf(v * inv), -127.f), 127.f));
        } else {
            xs[i] = __float2bfloat16_rn(v);
        }
    }
    __syncthreads();

    Acc acc[B][PROJ_VEC];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
        for (int j = 0; j < PROJ_VEC; ++j) acc[b][j] = 0;

    const Op* W = static_cast<const Op*>(w);
    for (int kb = 0; kb < k_chunk; kb += PROJ_ITER_ROWS) {
        V wv[PROJ_UNROLL];
#pragma unroll
        for (int u = 0; u < PROJ_UNROLL; ++u) {
            const int k = kb + (u * PROJ_WARPS + warp) * PROJ_WARP_ROWS + rl;
            wv[u] = k < k_chunk ? *reinterpret_cast<const V*>(W + (size_t)(k0 + k) * N + n0 + cl * PROJ_VEC) : V{};
        }
#pragma unroll
        for (int u = 0; u < PROJ_UNROLL; ++u) {
            const int k = kb + (u * PROJ_WARPS + warp) * PROJ_WARP_ROWS + rl;
            if (k >= k_chunk) continue;
            Acc wf[PROJ_VEC];
            WVec<INT8>::unpack(wv[u], wf);
#pragma unroll
            for (int b = 0; b < B; ++b) {
                Acc xv;
                if constexpr (INT8) xv = static_cast<int>(xs[b * k_chunk + k]);
                else xv = __bfloat162float(xs[b * k_chunk + k]);
#pragma unroll
                for (int j = 0; j < PROJ_VEC; ++j) acc[b][j] += xv * wf[j];
            }
        }
    }

    // lanes of one column group (same cl) hold partials of different rows
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
        for (int j = 0; j < PROJ_VEC; ++j)
#pragma unroll
            for (int o = PROJ_ROW_LANES; o < 32; o <<= 1) acc[b][j] += __shfl_xor_sync(0xffffffffu, acc[b][j], o);
    __syncthreads();  // the staged rows are dead; reuse smem for the cross-warp sums
    Acc* red = reinterpret_cast<Acc*>(smem);
    if (rl == 0) {
#pragma unroll
        for (int b = 0; b < B; ++b)
#pragma unroll
            for (int j = 0; j < PROJ_VEC; ++j) red[(warp * B + b) * PROJ_TILE + cl * PROJ_VEC + j] = acc[b][j];
    }
    __syncthreads();

    auto finish = [&](int b, int n, Acc s) {
        float v;
        if constexpr (INT8) v = static_cast<float>(s) * row_scale[b] * w_scale[n];
        else v = s;
        v += bias[n];
        y[b * N + n] = relu ? fmaxf(v, 0.f) : v;
    };
    Acc* parts = static_cast<Acc*>(part);
    for (int i = tid; i < B * PROJ_TILE; i += PROJ_THREADS) {
        const int b = i / PROJ_TILE, c = i % PROJ_TILE;
        Acc s = 0;
        for (int wi = 0; wi < PROJ_WARPS; ++wi) s += red[(wi * B + b) * PROJ_TILE + c];
        if (n_split == 1) finish(b, n0 + c, s);
        else parts[((size_t)split * B + b) * N + n0 + c] = s;
    }
    if (n_split == 1) return;

    // split-K: the last block of this column tile sums the partials in order
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&tickets[tile], 1) == n_split - 1;
    __syncthreads();
    if (!is_last) return;
    for (int i = tid; i < B * PROJ_TILE; i += PROJ_THREADS) {
        const int b = i / PROJ_TILE, n = n0 + i % PROJ_TILE;
        Acc s = 0;
        for (int sp = 0; sp < n_split; ++sp) s += __ldcg(&parts[((size_t)sp * B + b) * N + n]);
        finish(b, n, s);
    }
    if (tid == 0) tickets[tile] = 0;  // ready for the next launch on this stream
}

template <bool INT8>
cudaError_t launch_proj(const float* x, const void* w, const float* w_scale, const float* bias, float* y,
                        void* part, int* tickets, int n_tickets, int B, int K, int N, int n_split, int relu,
                        cudaStream_t stream) {
    if (N % PROJ_TILE || n_split < 1 || K % n_split || N / PROJ_TILE > n_tickets) return cudaErrorInvalidValue;
    const int k_chunk = K / n_split;
    const size_t stage = (size_t)B * k_chunk * (INT8 ? 1 : 2);
    const size_t red = (size_t)PROJ_WARPS * B * PROJ_TILE * 4;
    const size_t shm = stage > red ? stage : red;
    if (shm > 48 * 1024) return cudaErrorInvalidValue;
    const dim3 grid(N / PROJ_TILE, n_split);
    switch (B) {
#define GSV_PROJ_CASE(NB)                                                                               \
    case NB:                                                                                            \
        proj_kernel<NB, INT8><<<grid, PROJ_THREADS, shm, stream>>>(x, w, w_scale, bias, y, part, tickets, \
                                                                     K, N, k_chunk, relu);               \
        break;
        GSV_PROJ_CASE(1) GSV_PROJ_CASE(2) GSV_PROJ_CASE(3) GSV_PROJ_CASE(4)
        GSV_PROJ_CASE(5) GSV_PROJ_CASE(6) GSV_PROJ_CASE(7) GSV_PROJ_CASE(8)
#undef GSV_PROJ_CASE
        default:
            return cudaErrorInvalidValue;
    }
    return counted(C_PROJ);
}

// ---------------------------------------------------------------------------
// decode_attn: the new query of each (row, head) over the live cache prefix
// [0, n_valid), masked, plus its own fresh K/V. Flash-decoding in one launch:
// the prefix is cut into SPLIT-token pieces, one block per (split, head, row),
// each writing (ctx[dh], max, sum) to scratch; the last block of a (row, head)
// to finish (an atomic ticket, as in proj) merges the splits, in split order,
// with the fresh K/V.
// ---------------------------------------------------------------------------

constexpr int DH = 32;            // head dim of every S1 configuration served
constexpr int SPLIT = 64;         // cache slots per split block
constexpr int ATTN_THREADS = 128;
constexpr int PART = DH + 2;      // ctx[DH], max, sum

// one warp: merge the n_split partials of (row b, head h) with the query's
// own K/V into out (B, D). The partials may come from other blocks: read
// them from L2.
__device__ void attn_merge(const float* __restrict__ qkv, const float* part, float* __restrict__ out, int b, int h,
                           int H, int D, int n_split, float scale, int lane) {
    const float* row = qkv + (size_t)b * 3 * D;
    const float q = row[h * DH + lane] * scale;
    const float k_new = row[D + h * DH + lane];
    const float v_new = row[2 * D + h * DH + lane];
    const float sc_self = warp_sum(q * k_new);
    const float* pp = part + (size_t)(b * H + h) * n_split * PART;
    float m_all = sc_self;
    for (int s = 0; s < n_split; ++s) m_all = fmaxf(m_all, __ldcg(&pp[s * PART + DH]));
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
        const float a = expf(__ldcg(&pp[s * PART + DH]) - m_all);
        num = fmaf(a, __ldcg(&pp[s * PART + lane]), num);
        den = fmaf(a, __ldcg(&pp[s * PART + DH + 1]), den);
    }
    const float p_self = expf(sc_self - m_all);
    num = fmaf(p_self, v_new, num);
    den += p_self;
    out[(size_t)b * D + h * DH + lane] = num / den;
}

template <bool INT8>
__global__ void __launch_bounds__(ATTN_THREADS) attn_kernel(
    const float* __restrict__ qkv, const void* __restrict__ kv, const float* __restrict__ kv_scales,
    const float* __restrict__ mask, float* __restrict__ part, float* __restrict__ ctx_out, int* __restrict__ tickets,
    int H, int D, int T, int n_valid, int n_split, float scale) {
    const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int t0 = s * SPLIT;
    const int t1 = min(t0 + SPLIT, n_valid);
    const int n = max(t1 - t0, 0);
    float* out = part + ((size_t)(b * H + h) * n_split + s) * PART;

    __shared__ float q_f[DH];       // q * scale (f32)
    __shared__ float q_op[DH];      // the score operand: bf16-rounded q, or its int8 code
    __shared__ float w_t[SPLIT];    // bf16-rounded probs (bf16) / int8 prob codes (int8)
    __shared__ float red_f[ATTN_THREADS / 32];
    __shared__ float ctx_red[ATTN_THREADS / 32][DH];
    __shared__ float bcast[2];

    if (tid < DH) q_f[tid] = qkv[(size_t)b * 3 * D + h * DH + tid] * scale;
    __syncthreads();
    float q_scale = 1.f;
    if (warp == 0) {
        if (INT8) {
            // per-head dynamic int8 query
            const float a = warp_max(fabsf(q_f[lane]));
            q_scale = fmaxf(a, 1e-9f) * (1.0f / 127.0f);
            q_op[lane] = fminf(fmaxf(rintf(q_f[lane] / q_scale), -127.f), 127.f);
            if (lane == 0) bcast[0] = q_scale;
        } else {
            q_op[lane] = __bfloat162float(__float2bfloat16_rn(q_f[lane]));
        }
    }
    __syncthreads();
    if (INT8) q_scale = bcast[0];

    // pass 1a: one thread per cache slot computes its score
    float sc = -__int_as_float(0x7f800000);  // -inf: slots outside this split take no part
    const size_t row = (size_t)2 * D;
    if (tid < n) {
        const int t = t0 + tid;
        if (INT8) {
            const int8_t* kp = static_cast<const int8_t*>(kv) + ((size_t)b * T + t) * row + h * DH;
            int acc = 0;
#pragma unroll
            for (int d = 0; d < DH; ++d) acc += static_cast<int>(q_op[d]) * static_cast<int>(kp[d]);
            const float ks = kv_scales[((size_t)b * 2 + 0) * T + t];
            sc = static_cast<float>(acc) * (q_scale * ks);
        } else {
            const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(kv) + ((size_t)b * T + t) * row + h * DH;
            float acc = 0.f;
#pragma unroll
            for (int d = 0; d < DH; ++d) acc = fmaf(q_op[d], __bfloat162float(kp[d]), acc);
            sc = acc;
        }
        if (!(mask[(size_t)b * T + t] > 0.f)) sc = NEG;
    }
    // split max
    float m = warp_max(sc);
    if (lane == 0) red_f[warp] = m;
    __syncthreads();
    if (tid == 0) {
        float mm = red_f[0];
        for (int i = 1; i < ATTN_THREADS / 32; ++i) mm = fmaxf(mm, red_f[i]);
        bcast[0] = mm;
    }
    __syncthreads();
    m = bcast[0];
    float p = (tid < n) ? expf(sc - m) : 0.f;
    // split sum of the probs
    float ps = warp_sum(p);
    __syncthreads();
    if (lane == 0) red_f[warp] = ps;
    __syncthreads();
    if (tid == 0) {
        float ss = 0.f;
        for (int i = 0; i < ATTN_THREADS / 32; ++i) ss += red_f[i];
        bcast[1] = ss;
    }
    __syncthreads();
    const float p_sum = bcast[1];
    float p_scale = 1.f;
    if (INT8) {
        // probs carry the V scale, then quantize per head for this split
        const float pv = (tid < n) ? p * kv_scales[((size_t)b * 2 + 1) * T + t0 + tid] : 0.f;
        float pm = warp_max(pv);
        __syncthreads();
        if (lane == 0) red_f[warp] = pm;
        __syncthreads();
        if (tid == 0) {
            float mm = red_f[0];
            for (int i = 1; i < ATTN_THREADS / 32; ++i) mm = fmaxf(mm, red_f[i]);
            bcast[0] = fmaxf(mm, 1e-9f) * (1.0f / 127.0f);
        }
        __syncthreads();
        p_scale = bcast[0];
        if (tid < SPLIT) w_t[tid] = (tid < n) ? fminf(fmaxf(rintf(pv / p_scale), -127.f), 127.f) : 0.f;
    } else {
        if (tid < SPLIT) w_t[tid] = (tid < n) ? __bfloat162float(__float2bfloat16_rn(p)) : 0.f;
    }
    __syncthreads();

    // pass 1b: P @ V, warps split the slots, lanes own the head's channels
    float cacc = 0.f;
    int iacc = 0;
    for (int i = warp; i < n; i += ATTN_THREADS / 32) {
        const size_t off = ((size_t)b * T + t0 + i) * row + D + h * DH + lane;
        if (INT8) {
            iacc += static_cast<int>(w_t[i]) * static_cast<int>(static_cast<const int8_t*>(kv)[off]);
        } else {
            cacc = fmaf(w_t[i], __bfloat162float(static_cast<const __nv_bfloat16*>(kv)[off]), cacc);
        }
    }
    ctx_red[warp][lane] = INT8 ? static_cast<float>(iacc) : cacc;
    __syncthreads();
    if (warp == 0) {
        float c;
        if (INT8) {
            int ci = 0;
            for (int wi = 0; wi < ATTN_THREADS / 32; ++wi) ci += static_cast<int>(ctx_red[wi][lane]);
            c = static_cast<float>(ci) * p_scale;
        } else {
            c = 0.f;
            for (int wi = 0; wi < ATTN_THREADS / 32; ++wi) c += ctx_red[wi][lane];
        }
        out[lane] = (n > 0) ? c : 0.f;
        if (lane == 0) {
            out[DH] = (n > 0) ? m : NEG;
            out[DH + 1] = (n > 0) ? p_sum : 0.f;
        }
    }

    // the last split block of this (row, head) merges all the splits
    __shared__ int is_last;
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = n_split == 1 || atomicAdd(&tickets[b * H + h], 1) == n_split - 1;
    __syncthreads();
    if (!is_last) return;
    if (warp == 0) attn_merge(qkv, part, ctx_out, b, h, H, D, n_split, scale, lane);
    if (tid == 0 && n_split > 1) tickets[b * H + h] = 0;  // ready for the next launch on this stream
}

// ---------------------------------------------------------------------------
// add_layernorm: out = LN(x + y) * scale + bias, eps 1e-5, one block per row
// ---------------------------------------------------------------------------

constexpr int LN_THREADS = 256;

__global__ void __launch_bounds__(LN_THREADS) add_layernorm_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ out, int D) {
    extern __shared__ float buf[];  // D floats
    __shared__ float red[LN_THREADS / 32];
    __shared__ float stat;
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float s = 0.f;
    for (int i = tid; i < D; i += LN_THREADS) {
        const float v = x[(size_t)b * D + i] + y[(size_t)b * D + i];
        buf[i] = v;
        s += v;
    }
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (tid == 0) {
        float t = 0.f;
        for (int i = 0; i < LN_THREADS / 32; ++i) t += red[i];
        stat = t / static_cast<float>(D);
    }
    __syncthreads();
    const float mu = stat;
    float v2 = 0.f;
    for (int i = tid; i < D; i += LN_THREADS) {
        const float d = buf[i] - mu;
        v2 += d * d;
    }
    v2 = warp_sum(v2);
    __syncthreads();
    if (lane == 0) red[warp] = v2;
    __syncthreads();
    if (tid == 0) {
        float t = 0.f;
        for (int i = 0; i < LN_THREADS / 32; ++i) t += red[i];
        stat = 1.0f / sqrtf(t / static_cast<float>(D) + 1e-5f);
    }
    __syncthreads();
    const float r = stat;
    for (int i = tid; i < D; i += LN_THREADS) out[(size_t)b * D + i] = (buf[i] - mu) * r * scale[i] + bias[i];
}

cudaError_t launch_attn(const float* qkv, const void* kv, const float* kv_scales, const float* mask, float* part,
                        float* out, int* tickets, int n_tickets, int B, int H, int D, int T, int n_valid, int n_split,
                        float scale, int int8, cudaStream_t st) {
    if (D != H * DH || n_split < 1 || n_split * SPLIT < n_valid || B * H > n_tickets) return cudaErrorInvalidValue;
    const dim3 grid(n_split, H, B);
    if (int8)
        attn_kernel<true><<<grid, ATTN_THREADS, 0, st>>>(qkv, kv, kv_scales, mask, part, out, tickets, H, D, T,
                                                         n_valid, n_split, scale);
    else
        attn_kernel<false><<<grid, ATTN_THREADS, 0, st>>>(qkv, kv, kv_scales, mask, part, out, tickets, H, D, T,
                                                          n_valid, n_split, scale);
    return counted(C_ATTN);
}

cudaError_t launch_ln(const float* x, const float* y, const float* scale, const float* bias, float* out, int B, int D,
                      cudaStream_t st) {
    add_layernorm_kernel<<<B, LN_THREADS, D * sizeof(float), st>>>(x, y, scale, bias, out, D);
    return counted(C_LN);
}

cudaError_t launch_proj_any(int int8, const float* x, const void* w, const float* w_scale, const float* bias,
                            float* y, void* part, int* tickets, int n_tickets, int B, int K, int N, int n_split,
                            int relu, cudaStream_t st) {
    return int8 ? launch_proj<true>(x, w, w_scale, bias, y, part, tickets, n_tickets, B, K, N, n_split, relu, st)
                : launch_proj<false>(x, w, w_scale, bias, y, part, tickets, n_tickets, B, K, N, n_split, relu, st);
}

// ---------------------------------------------------------------------------
// The whole step as one persistent launch (step_kernel, gsv_decode_step)
//
// GRID = 128 blocks of 256 threads, all co-resident (a cooperative launch:
// it fails rather than run a grid whose blocks cannot all be resident), one
// an SM. A layer is five phases, each ended by a grid barrier:
//   1. every block computes the layer input x = LN2 of the previous layer
//      from its own copy of xn and the MLP output y2 (B <= 8 rows of 512, in
//      L2), then blocks 0..95 each project 16 of qkv's 1536 columns;
//   2. a block a (row, head): its warps take 32 x slot_r-slot splits of the
//      live prefix, and warp 0 merges their partials from shared memory, in
//      split order, with the query's own fresh K/V into ctx;
//   3. blocks 96..127 project 16 of wo's 512 columns (the attention
//      output), while 2B others write the new token's K/V into the cache at
//      write_idx (quantized per token in int8-KV mode);
//   4. every block computes xn = LN1(x + attention output), then blocks
//      0..127 project 16 of fc1's 2048 columns, with ReLU;
//   5. blocks 96..127 project 16 of fc2's 512 columns over all 2048 of K.
// No projection is split over K, so every output is one block's fixed-order
// sum and no partials need a second pass. After the last layer block 0
// writes LN2 of its output.
//
// Weights are stacked K-major, (L, N, K), each 16 rows in the order of the
// mma's A fragments (ops/decode_step.py stack_weights_from_params,
// to_fragment_order), so a block's 16 output columns of a layer are one
// contiguous block of memory. Each block owns the same 16 columns of each
// projection in every layer and keeps one shared-memory buffer per
// projection; in a phase where it has no projection of its own it issues
// the next layer's block into a used buffer with one 1-D TMA copy
// (cp.async.bulk) completing on that buffer's mbarrier, so a layer's
// weights stream in while the block runs other phases and waits at their
// barriers. The products run on tensor cores: mma.sync m16n8k32 s8 (or
// m16n8k16 bf16) with the 16 weight rows as A, a lane's four registers one
// 16-byte shared load, and the B <= 8 activation rows (padded by 16 bytes
// a row, so that fragment loads hit 32 banks) in the n = 8 slot, each warp
// an eighth of K, summed across warps in order.
//
// The grid barrier is one counter in global memory that only grows: a block
// arrives with a release add and spins with acquire loads until the count
// has grown by GRID since the barrier before (every launch starts from the
// count the last one left). An attention split loads everything it needs
// before it uses any of it. A spin, like an mbarrier wait, that outlasts
// ~10 s of clocks traps, so a fault ends the kernel with an error instead of
// hanging the card.
// ---------------------------------------------------------------------------

namespace step {

constexpr int D = 512, F = 2048, H = 16;  // the S1 widths served (S1Config)
constexpr int ROWS = 8;                   // batch rows: the mma's n = 8 slot
constexpr int COLS = 16;                  // output columns a block owns: the mma's m = 16
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int N_QKV = 3 * D / COLS, N_WO = D / COLS, N_FC1 = F / COLS;  // column items: 96, 32, 128
constexpr int GRID = N_FC1 > N_QKV ? N_FC1 : N_QKV;                      // 128 blocks
constexpr int MAX_SLOT_R = 4;             // cache slots per lane of an attention split: 1, 2 or 4 (int8 KV)
constexpr int MAX_SPLITS = 128;           // attention splits a (row, head): 8192 slots (bf16 KV), 16384 (int8)
constexpr long long SPIN_LIMIT = 20000000000LL;  // clocks, ~10 s

enum Proj { P_QKV, P_WO, P_FC1, P_FC2 };

__host__ __device__ constexpr int proj_k(int p) { return p == P_FC2 ? F : D; }
__host__ __device__ constexpr int proj_n(int p) { return p == P_QKV ? 3 * D : p == P_FC1 ? F : D; }
// the bias of each projection among the step's vectors (bqkv, bo, n1s, n1b, n2s, n2b, b1, b2)
__host__ __device__ constexpr int proj_bias(int p) { return p == P_QKV ? 0 : p == P_WO ? 1 : p == P_FC1 ? 6 : 7; }

// the block's item (column tile) of projection p, or -1: qkv and fc1 on
// blocks 0.., wo and fc2 on the last N_WO blocks
static_assert(N_QKV <= GRID - N_WO && N_FC1 <= GRID, "a block owns qkv or wo/fc2, never both (the refill plan)");
__device__ __forceinline__ int item_of(int p, int blk) {
    if (p == P_QKV) return blk < N_QKV ? blk : -1;
    if (p == P_FC1) return blk < N_FC1 ? blk : -1;
    const int j = blk - (GRID - N_WO);
    return j >= 0 && j < N_WO ? j : -1;
}

// dynamic shared memory, in bytes from the base
template <bool INT8>
__host__ __device__ constexpr int row_bytes(int k) {  // an activation row, padded so that fragment loads hit 32 banks
    return k * (INT8 ? 1 : 2) + 16;
}
template <bool INT8>
__host__ __device__ constexpr int w_rows_bytes(int p) {  // the item's weight rows; its bias and scales follow
    return COLS * proj_k(p) * (INT8 ? 1 : 2);
}
template <bool INT8>
__host__ __device__ constexpr int w_bytes(int p) {
    return w_rows_bytes<INT8>(p) + 2 * COLS * 4;
}
template <bool INT8>
__host__ __device__ constexpr int w_off(int p) {  // the weight buffer of projection p
    return p == 0 ? 0 : w_off<INT8>(p - 1) + w_bytes<INT8>(p - 1);
}
template <bool INT8>
struct Layout {
    static constexpr int ELT = INT8 ? 1 : 2;
    static constexpr int X = w_off<INT8>(3) + w_bytes<INT8>(3);  // activation rows (ROWS x row_bytes(K))
    static constexpr int XS = X + ROWS * row_bytes<INT8>(F);     // x, the layer input (ROWS x D f32)
    static constexpr int XN = XS + ROWS * D * 4;                 // xn, LN1's output
    static constexpr int RED = XN + ROWS * D * 4;                // the warps' partial products
    static constexpr int SCALE = RED + WARPS * COLS * ROWS * 4;  // activation row scales
    static constexpr int QF = SCALE + ROWS * 4 + 16;             // per warp: the query (32 f32)
    static constexpr int QW = QF + WARPS * 32 * 4;               // per warp: its int8 codes (32 bytes)
    static constexpr int PARTS = QW + WARPS * 32;                // the attention splits' partials (ctx, max, sum)
    static constexpr int LN = PARTS + MAX_SPLITS * PART * 4;     // two layers' n1s, n1b, n2s, n2b (D f32 each)
    static constexpr int BARS = LN + 2 * 4 * D * 4;              // an mbarrier per weight buffer, then per LN buffer
    static constexpr int SMEM = BARS + 6 * 8;
    static_assert(X % 16 == 0 && QW % 16 == 0 && SMEM <= 232448, "shared memory layout");
};

struct StepArgs {
    const float* x;      // (B, D) the layer-0 input
    float* out;          // (B, D) the step's output
    const void* w[4];    // wqkv, wo, fc1, fc2: (L, N, K) bf16 or int8
    const float* ws[4];  // their (L, 1, N) scales (int8 weights)
    const float* vec[8]; // bqkv, bo, n1s, n1b, n2s, n2b, b1, b2: (L, 1, N) f32
    void* kv;            // (L, B, T, 2D) bf16 or int8
    float* kv_scales;    // (L, B, 2, T) f32 (int8 KV)
    const float* mask;   // (B, T)
    float* qkv;          // (B, 3D) scratch
    float* ctx;          // (B, D) the attention output
    float* attn;         // (B, D) wo's output
    float* hdn;          // (B, F) fc1's output
    float* y2;           // (B, D) fc2's output
    unsigned* sync;      // the grid barrier's count
    float scale;
    int L, B, T, n_valid;
    int n_split, slot_r;  // attention splits a (row, head), each of 32 x slot_r cache slots
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    const long long t0 = clock64();
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (!done && clock64() - t0 > SPIN_LIMIT) __trap();
    } while (!done);
}

// `bytes` (a multiple of 16) from global memory into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
                 : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// The grid barrier: a counter that only grows. Thread 0 of each block adds
// 1 with release semantics and spins (acquire) until the counter reaches
// `target`, GRID arrivals a barrier past the launch's base.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(count), "r"(1u) : "memory");
        const long long t0 = clock64();
        while (static_cast<int>(ld_acquire(count) - target) < 0)
            if (clock64() - t0 > SPIN_LIMIT) __trap();
    }
    __syncthreads();
}

__device__ __forceinline__ unsigned lds32(const uint8_t* p) { return *reinterpret_cast<const unsigned*>(p); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// By lanes 0-2 of one warp, once the block is done with the buffer: the 16
// rows (output columns item * 16..) of projection p in layer `layer`, one
// contiguous block of the fragment-ordered stack, into the block's buffer,
// then their 16 biases and (int8) weight scales.
template <bool INT8>
__device__ void issue_weights(const StepArgs& a, uint8_t* smem, uint64_t* bar, int p, int layer, int item) {
    const int lane = threadIdx.x & 31;
    const int N = proj_n(p);
    const uint32_t bytes = w_rows_bytes<INT8>(p);
    const size_t col0 = (size_t)layer * N + (size_t)item * COLS;
    uint8_t* dst = smem + w_off<INT8>(p);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the block's reads of the buffer
    if (lane == 0) mbar_expect_tx(bar, bytes + (INT8 ? 2 : 1) * COLS * 4);
    __syncwarp();
    if (lane == 0)
        bulk_load(dst, static_cast<const uint8_t*>(a.w[p]) + col0 * proj_k(p) * (INT8 ? 1 : 2), bytes, bar);
    else if (lane == 1)
        bulk_load(dst + bytes, a.vec[proj_bias(p)] + col0, COLS * 4, bar);
    else if (INT8 && lane == 2)
        bulk_load(dst + bytes + COLS * 4, a.ws[p] + col0, COLS * 4, bar);
}

// By every lane of one warp: n1s, n1b, n2s, n2b of layer `layer` into the
// LN buffer `ln`.
__device__ void issue_ln(const StepArgs& a, float* ln, uint64_t* bar, int layer) {
    const int lane = threadIdx.x & 31;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_expect_tx(bar, 4 * D * 4);
    __syncwarp();
    if (lane < 4) bulk_load(ln + lane * D, a.vec[2 + lane] + (size_t)layer * D, D * 4, bar);
}

// LN(res + y) * scale + bias over rows of D, eps 1e-5, a warp a row; res in
// shared memory, y written by other blocks (read from L2)
__device__ void layer_norm_rows(const float* res, const float* y, const float* scale, const float* bias, float* dst,
                                int B) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp >= B) return;
    constexpr int V = D / 128;  // float4s a lane
    float v[V][4];
    float4 sc4[V], bi4[V];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
        const int k = (i * 32 + lane) * 4;
        const float4 r = *reinterpret_cast<const float4*>(res + warp * D + k);
        const float4 u = __ldcg(reinterpret_cast<const float4*>(y + warp * D + k));
        sc4[i] = *reinterpret_cast<const float4*>(scale + k);
        bi4[i] = *reinterpret_cast<const float4*>(bias + k);
        v[i][0] = r.x + u.x;
        v[i][1] = r.y + u.y;
        v[i][2] = r.z + u.z;
        v[i][3] = r.w + u.w;
        s += v[i][0] + v[i][1] + v[i][2] + v[i][3];
    }
    const float mu = warp_sum(s) / static_cast<float>(D);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) q += (v[i][j] - mu) * (v[i][j] - mu);
    const float rs = 1.0f / sqrtf(warp_sum(q) / static_cast<float>(D) + 1e-5f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
        const int k = (i * 32 + lane) * 4;
        float4 o;
        o.x = (v[i][0] - mu) * rs * sc4[i].x + bi4[i].x;
        o.y = (v[i][1] - mu) * rs * sc4[i].y + bi4[i].y;
        o.z = (v[i][2] - mu) * rs * sc4[i].z + bi4[i].z;
        o.w = (v[i][3] - mu) * rs * sc4[i].w + bi4[i].w;
        *reinterpret_cast<float4*>(dst + warp * D + k) = o;
    }
}

// The B activation rows (K f32 each; in shared memory, or written by other
// blocks) as the mma's operand: int8 codes with a per-row scale over the
// whole row (max(max|x|, 1e-6) / 127, round half to even), or bf16. A warp
// a row; the rows past B are zeros.
template <bool INT8, int K>
__device__ void stage_rows(const float* src, bool from_l2, int B, uint8_t* X, float* row_scale) {
    constexpr int RB = row_bytes<INT8>(K);
    constexpr int V = K / 128;  // float4s a lane
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    uint8_t* dst = X + warp * RB;
    if (warp >= B) {
        for (int i = lane; i < K * Layout<INT8>::ELT / 16; i += 32) reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
        return;
    }
    float4 v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        const float4* p = reinterpret_cast<const float4*>(src + warp * K + (i * 32 + lane) * 4);
        v[i] = from_l2 ? __ldcg(p) : *p;
    }
    if constexpr (INT8) {
        float m = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) m = fmaxf(m, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)), fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
        const float xs = fmaxf(warp_max(m), 1e-6f) * (1.0f / 127.0f);
        const float inv = 1.0f / xs;
        if (lane == 0) row_scale[warp] = xs;
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
            uint32_t w = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                w |= (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(e[j] * inv), -127.f), 127.f) << (8 * j);
            *reinterpret_cast<uint32_t*>(dst + (i * 32 + lane) * 4) = w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(v[i].x, v[i].y), hi = __floats2bfloat162_rn(v[i].z, v[i].w);
            uint2 w;
            w.x = *reinterpret_cast<uint32_t*>(&lo);
            w.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(dst + (i * 32 + lane) * 8) = w;
        }
    }
}

// This warp's eighth of K of the 16 x B product, into red[warp][col][row].
// W is the item's 16 rows in fragment order (ops/decode_step.py
// to_fragment_order): for each k-step (32 int8 or 16 bf16 of K) 512 bytes,
// 16 a lane holding its four A registers, so a lane loads them in one
// conflict-free 16-byte access. X holds the activation rows, padded.
template <bool INT8, int K>
__device__ void item_mma(const uint8_t* W, const uint8_t* X, float* red) {
    constexpr int RB = row_bytes<INT8>(K);
    constexpr int KS = INT8 ? 32 : 16;  // K a k-step
    constexpr int STEPS = K / KS / WARPS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const uint4* wf = reinterpret_cast<const uint4*>(W) + warp * STEPS * 32 + lane;
    const uint8_t* xr = X + g * RB;
    float* out = red + warp * COLS * ROWS;
    using Acc = std::conditional_t<INT8, int, float>;
    Acc c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
        const uint4 a4 = wf[j * 32];
        const unsigned a[4] = {a4.x, a4.y, a4.z, a4.w};
        const int k = ((warp * STEPS + j) * KS) * (INT8 ? 1 : 2) + t * 4;  // bytes: 4 t of the step's first half
        const unsigned bb[2] = {lds32(xr + k), lds32(xr + k + 16)};
        if constexpr (INT8) mma_s8(c, a, bb);
        else mma_bf16(c, a, bb);
    }
    Acc* o = reinterpret_cast<Acc*>(out);
    o[g * ROWS + 2 * t] = c[0];
    o[g * ROWS + 2 * t + 1] = c[1];
    o[(g + 8) * ROWS + 2 * t] = c[2];
    o[(g + 8) * ROWS + 2 * t + 1] = c[3];
}

// The block's 16 columns of projection p in layer l: y = act(x @ W + b)
// (W8A8: acc * xs * w_scale + b) for the B rows of src, into dst (B, N).
template <bool INT8, int K>
__device__ void project(const StepArgs& a, uint8_t* smem, int p, int l, int item, const float* src, bool from_l2,
                        float* dst, bool relu) {
    using Lay = Layout<INT8>;
    float* red = reinterpret_cast<float*>(smem + Lay::RED);
    float* row_scale = reinterpret_cast<float*>(smem + Lay::SCALE);
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Lay::BARS) + p;
    // a thread of the first COLS * ROWS finishes (column c, row r)
    const int c = threadIdx.x / ROWS, r = threadIdx.x % ROWS, N = proj_n(p), n = item * COLS + c;
    const bool finisher = threadIdx.x < COLS * ROWS && r < a.B;
    const float* tail = reinterpret_cast<const float*>(smem + w_off<INT8>(p) + w_rows_bytes<INT8>(p));
    stage_rows<INT8, K>(src, from_l2, a.B, smem + Lay::X, row_scale);
    __syncthreads();
    mbar_wait(bar, l & 1);
    const float bias = finisher ? tail[c] : 0.f, w_scale = finisher && INT8 ? tail[COLS + c] : 0.f;
    item_mma<INT8, K>(smem + w_off<INT8>(p), smem + Lay::X, red);
    __syncthreads();
    if (finisher) {
        float v;
        if constexpr (INT8) {
            const int* ri = reinterpret_cast<const int*>(red);
            int sum = 0;
            for (int w = 0; w < WARPS; ++w) sum += ri[(w * COLS + c) * ROWS + r];
            v = static_cast<float>(sum) * row_scale[r] * w_scale;
        } else {
            v = 0.f;
            for (int w = 0; w < WARPS; ++w) v += red[(w * COLS + c) * ROWS + r];
        }
        v += bias;
        dst[(size_t)r * N + n] = relu ? fmaxf(v, 0.f) : v;
    }
}

// One halving exchange of reduce_scatter32: lanes with bit O keep the upper
// O of their 2 O values, the others the lower, each adding its partner's.
template <int O, typename T>
__device__ __forceinline__ void halve(T (&v)[32], int lane) {
    const bool hi = lane & O;
#pragma unroll
    for (int i = 0; i < O; ++i) {
        const T send = hi ? v[i] : v[i + O];
        const T keep = hi ? v[i + O] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
}

// The sum over the warp of each lane's 32 values, lane d ending with the
// sum of values d: five halving exchanges (recursive halving), in a fixed
// order, every index known at compile time so that v stays in registers.
template <typename T>
__device__ __forceinline__ T reduce_scatter32(T (&v)[32], int lane) {
    halve<16>(v, lane);
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
    halve<1>(v, lane);
    return v[0];
}

// One warp: split s of (row b, head h), the 32 R cache slots from 32 R s
// (lane j takes slots 32 r + j), masked, into the partial part = (ctx[DH],
// max, sum) in shared memory. Every load of the split is issued before any
// is used: the query, and each lane's slots' K and V of the head, mask and
// scales. P @ V: each lane weighs its slots' V, and a reduce-scatter over
// the warp leaves channel d on lane d.
template <bool KV8, int R>
__device__ void attn_split(const StepArgs& a, int layer, int bh, int s, float* part, float* q_s, uint8_t* qc_s) {
    using E = std::conditional_t<KV8, int8_t, __nv_bfloat16>;
    using Acc = std::conditional_t<KV8, int, float>;
    constexpr int VECS = DH * sizeof(E) / 16;  // 16-byte loads of a head's K (or V) of one slot
    constexpr int PER = 16 / sizeof(E);        // values a load
    const int lane = threadIdx.x & 31;
    const int h = bh % H, b = bh / H;
    const int T = a.T;
    const size_t row = 2 * D;
    const int t0 = s * 32 * R;
    const int n = max(min(t0 + 32 * R, a.n_valid) - t0, 0);
    const float* ks = KV8 ? a.kv_scales + ((size_t)layer * a.B + b) * 2 * T : nullptr;
    const float* qkv = a.qkv + (size_t)b * 3 * D;
    const E* kv_row = static_cast<const E*>(a.kv) + (size_t)layer * a.B * T * row + (size_t)b * T * row + h * DH;

    const float qv = __ldcg(qkv + h * DH + lane) * a.scale;
    uint4 kr[R][VECS], vr[R][VECS];
    float mk[R], k_sc[R], v_sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = r * 32 + lane, t = t0 + j;
        mk[r] = k_sc[r] = v_sc[r] = 0.f;
        if (j < n) {
            const E* kp = kv_row + (size_t)t * row;
#pragma unroll
            for (int c = 0; c < VECS; ++c) {
                kr[r][c] = reinterpret_cast<const uint4*>(kp)[c];
                vr[r][c] = reinterpret_cast<const uint4*>(kp + D)[c];
            }
            mk[r] = a.mask[(size_t)b * T + t];
            if constexpr (KV8) {
                k_sc[r] = ks[t];
                v_sc[r] = ks[T + t];
            }
        } else {
#pragma unroll
            for (int c = 0; c < VECS; ++c) kr[r][c] = vr[r][c] = make_uint4(0, 0, 0, 0);
        }
    }

    __syncwarp();  // the previous item's reads of q_s and qc_s are done
    float q_scale = 1.f;
    if constexpr (KV8) {  // per-head dynamic int8 query
        q_scale = fmaxf(warp_max(fabsf(qv)), 1e-9f) * (1.0f / 127.0f);
        qc_s[lane] = (uint8_t)(int8_t)fminf(fmaxf(rintf(qv / q_scale), -127.f), 127.f);
    } else {
        q_s[lane] = __bfloat162float(__float2bfloat16_rn(qv));
    }
    __syncwarp();

    // scores: a lane R slots
    float sc[R];
    float m_lane = -__int_as_float(0x7f800000);  // -inf: slots past the split take no part
#pragma unroll
    for (int r = 0; r < R; ++r) {
        sc[r] = -__int_as_float(0x7f800000);
        if (r * 32 + lane < n) {
            if constexpr (KV8) {
                const unsigned* qw = reinterpret_cast<const unsigned*>(qc_s);
                int acc = 0;
#pragma unroll
                for (int c = 0; c < VECS; ++c) {
                    acc = __dp4a((int)kr[r][c].x, (int)qw[4 * c], acc);
                    acc = __dp4a((int)kr[r][c].y, (int)qw[4 * c + 1], acc);
                    acc = __dp4a((int)kr[r][c].z, (int)qw[4 * c + 2], acc);
                    acc = __dp4a((int)kr[r][c].w, (int)qw[4 * c + 3], acc);
                }
                sc[r] = static_cast<float>(acc) * (q_scale * k_sc[r]);
            } else {
                float acc = 0.f;
#pragma unroll
                for (int c = 0; c < VECS; ++c) {
                    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&kr[r][c]);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float2 f = __bfloat1622float2(p2[j]);
                        acc = fmaf(q_s[8 * c + 2 * j], f.x, acc);
                        acc = fmaf(q_s[8 * c + 2 * j + 1], f.y, acc);
                    }
                }
                sc[r] = acc;
            }
            if (!(mk[r] > 0.f)) sc[r] = NEG;
        }
        m_lane = fmaxf(m_lane, sc[r]);
    }
    const float m = warp_max(m_lane);
    float p[R], p_lane = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        p[r] = r * 32 + lane < n ? expf(sc[r] - m) : 0.f;
        p_lane += p[r];
    }
    const float p_sum = warp_sum(p_lane);
    Acc w[R];
    float p_scale = 1.f;
    if constexpr (KV8) {  // probs carry the V scale, then quantize per head for this split
        float pm = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            p[r] *= v_sc[r];
            pm = fmaxf(pm, p[r]);
        }
        p_scale = fmaxf(warp_max(pm), 1e-9f) * (1.0f / 127.0f);
#pragma unroll
        for (int r = 0; r < R; ++r) w[r] = static_cast<int>(fminf(fmaxf(rintf(p[r] / p_scale), -127.f), 127.f));
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r) w[r] = __bfloat162float(__float2bfloat16_rn(p[r]));
    }

    // P @ V: each lane its slots' weighted V, then the warp's sum per channel
    Acc acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < VECS; ++c) {
            const uint32_t words[4] = {vr[r][c].x, vr[r][c].y, vr[r][c].z, vr[r][c].w};
#pragma unroll
            for (int e = 0; e < PER; ++e) {
                if constexpr (KV8) {
                    const int v = static_cast<int8_t>((words[e >> 2] >> (8 * (e & 3))) & 0xffu);
                    acc[c * PER + e] += w[r] * v;
                } else {
                    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&words[e >> 1]);
                    const float v = (e & 1) ? __high2float(pair) : __low2float(pair);
                    acc[c * PER + e] = fmaf(w[r], v, acc[c * PER + e]);
                }
            }
        }
    const Acc mine = reduce_scatter32<Acc>(acc, lane);
    const float ctx = KV8 ? static_cast<float>(mine) * p_scale : static_cast<float>(mine);
    part[lane] = n > 0 ? ctx : 0.f;
    if (lane == 0) {
        part[DH] = n > 0 ? m : NEG;
        part[DH + 1] = n > 0 ? p_sum : 0.f;
    }
}

// One block: the new query of (row b, head h) = bh over the live cache
// prefix, cut into n_split splits (warp w takes splits w, w + 8, ...), then
// warp 0 merges the splits' partials, in split order, with the query's own
// fresh K/V into ctx.
template <bool KV8, int R>
__device__ void attn_pair(const StepArgs& a, int layer, int bh, float* part_s, float* q_s, uint8_t* qc_s) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int h = bh % H, b = bh / H, ns = a.n_split;
    const float* qkv = a.qkv + (size_t)b * 3 * D + h * DH;
    float qv = 0.f, k_new = 0.f, v_new = 0.f;
    if (warp == 0) {  // the fresh K/V for the merge, in flight meanwhile
        qv = __ldcg(qkv + lane) * a.scale;
        k_new = __ldcg(qkv + D + lane);
        v_new = __ldcg(qkv + 2 * D + lane);
    }
    for (int s = warp; s < ns; s += WARPS) attn_split<KV8, R>(a, layer, bh, s, part_s + s * PART, q_s, qc_s);
    __syncthreads();
    if (warp == 0) {
        // lane i holds split i's max and sum (32 splits at a time), lane d
        // the context's channel d
        const float sc_self = warp_sum(qv * k_new);
        float m_all = sc_self;
        for (int i0 = 0; i0 < ns; i0 += 32)
            m_all = fmaxf(m_all, warp_max(i0 + lane < ns ? part_s[(i0 + lane) * PART + DH] : m_all));
        float num = 0.f, den = 0.f;
        for (int i0 = 0; i0 < ns; i0 += 32) {
            const int i = i0 + lane, cnt = min(32, ns - i0);
            float al = 0.f, si = 0.f;
            if (i < ns) {
                al = expf(part_s[i * PART + DH] - m_all);
                si = part_s[i * PART + DH + 1];
            }
            den += warp_sum(al * si);
            for (int j = 0; j < cnt; ++j)
                num = fmaf(__shfl_sync(0xffffffffu, al, j), part_s[(i0 + j) * PART + lane], num);
        }
        const float w_self = expf(sc_self - m_all);  // the fresh K/V's weight
        num = fmaf(w_self, v_new, num);
        den += w_self;
        a.ctx[(size_t)b * D + h * DH + lane] = num / den;
    }
    __syncthreads();  // part_s is free for the next pair
}

// One warp: the new token's K (side 0) or V (side 1) of row b into the cache
// at n_valid (write_idx), as bf16, or as int8 codes with a per-token scale
// max(max|x|, ...) / 127 of the bf16 values (ops/decode_step.py _write_new_kv).
template <bool KV8>
__device__ void kv_write_item(const StepArgs& a, int layer, int j) {
    const int lane = threadIdx.x & 31, b = j >> 1, side = j & 1;
    const float* src = a.qkv + (size_t)b * 3 * D + D + side * D;
    const size_t dst = (((size_t)layer * a.B + b) * a.T + a.n_valid) * 2 * D + side * D;
    constexpr int V = D / 32;
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(__float2bfloat16_rn(__ldcg(src + i * 32 + lane)));
    if constexpr (KV8) {
        float m = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) m = fmaxf(m, fabsf(v[i]));
        const float s = fmaxf(warp_max(m) / 127.0f, 1e-8f);
        int8_t* kv = static_cast<int8_t*>(a.kv) + dst;
#pragma unroll
        for (int i = 0; i < V; ++i) kv[i * 32 + lane] = (int8_t)fminf(fmaxf(rintf(v[i] / s), -127.f), 127.f);
        if (lane == 0) a.kv_scales[(((size_t)layer * a.B + b) * 2 + side) * a.T + a.n_valid] = s;
    } else {
        __nv_bfloat16* kv = static_cast<__nv_bfloat16*>(a.kv) + dst;
#pragma unroll
        for (int i = 0; i < V; ++i) kv[i * 32 + lane] = __float2bfloat16_rn(v[i]);
    }
}

template <bool W8, bool KV8>
__global__ void __launch_bounds__(THREADS, 1) step_kernel(const StepArgs a) {
    using Lay = Layout<W8>;
    extern __shared__ __align__(16) uint8_t smem[];
    float* x_s = reinterpret_cast<float*>(smem + Lay::XS);
    float* xn_s = reinterpret_cast<float*>(smem + Lay::XN);
    float* ln_s = reinterpret_cast<float*>(smem + Lay::LN);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Lay::BARS);  // 4 weight buffers, then 2 LN buffers
    const int tid = threadIdx.x, warp = tid >> 5, blk = blockIdx.x, B = a.B;
    int item[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) item[p] = item_of(p, blk);

    if (tid == 0) {
        for (int p = 0; p < 6; ++p) mbar_init(&bars[p], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int i = tid; i < B * D; i += THREADS) x_s[i] = a.x[i];
    // the barrier count left by earlier launches: a multiple of GRID, less
    // any arrivals at this launch's first barrier
    unsigned base = 0, n_bar = 0;
    if (tid == 0) base = ld_acquire(a.sync) / GRID * GRID;
    __syncthreads();

    // LN buffer j holds the norms of layers j, j + 2, ...: n1s, n1b, n2s, n2b
    auto ln = [&](int layer, int j) { return ln_s + ((layer & 1) * 4 + j) * D; };
    // The last warp refills a weight buffer with layer `layer`'s rows in a
    // phase where the block has no projection of its own, after the phase
    // that used it: blocks 0..95 (qkv, fc1) refill qkv in phase 3 and fc1 in
    // phase 5; blocks 96..127 (wo, fc1, fc2) refill all three in phase 1 of
    // the layer that needs them.
    auto refill = [&](int p, int layer) {
        if (warp == WARPS - 1 && item[p] >= 0 && layer < a.L) issue_weights<W8>(a, smem, &bars[p], p, layer, item[p]);
    };
    if (warp == WARPS - 1) {
        for (int p = 0; p < 4; ++p)
            if (item[p] >= 0) issue_weights<W8>(a, smem, &bars[p], p, 0, item[p]);
        for (int l = 0; l < 2 && l < a.L; ++l) issue_ln(a, ln(l, 0), &bars[4 + l], l);
    }

    for (int l = 0; l < a.L; ++l) {
        // 1. x = LN2(xn + y2) of the previous layer; qkv = x @ Wqkv + bqkv
        if (l > 0) {
            layer_norm_rows(xn_s, a.y2, ln(l - 1, 2), ln(l - 1, 3), x_s, B);
            __syncthreads();
        }
        if (item[P_QKV] >= 0) {
            project<W8, D>(a, smem, P_QKV, l, item[P_QKV], x_s, false, a.qkv, false);
        } else if (l > 0) {
            refill(P_WO, l);
            refill(P_FC1, l);
            refill(P_FC2, l);
        }
        if (warp == WARPS - 2 && l > 0 && l + 1 < a.L)  // layer l - 1's norms are used: layer l + 1's
            issue_ln(a, ln(l + 1, 0), &bars[4 + ((l + 1) & 1)], l + 1);
        grid_sync(a.sync, base + ++n_bar * GRID);  // qkv written

        // 2. attention: a block a (row, head)
        {
            float* part_s = reinterpret_cast<float*>(smem + Lay::PARTS);
            float* q_s = reinterpret_cast<float*>(smem + Lay::QF) + warp * 32;
            uint8_t* qc_s = smem + Lay::QW + warp * 32;
            for (int bh = blk; bh < B * H; bh += gridDim.x) {
                if (KV8 && a.slot_r == 4) attn_pair<KV8, (KV8 ? 4 : 2)>(a, l, bh, part_s, q_s, qc_s);
                else if (a.slot_r == 2) attn_pair<KV8, 2>(a, l, bh, part_s, q_s, qc_s);
                else attn_pair<KV8, 1>(a, l, bh, part_s, q_s, qc_s);
            }
        }
        grid_sync(a.sync, base + ++n_bar * GRID);  // ctx written

        // 3. the attention output: ctx @ Wo + bo; meanwhile blocks without a
        // wo item write the new token's K/V into the cache at write_idx
        if (item[P_WO] >= 0) {
            project<W8, D>(a, smem, P_WO, l, item[P_WO], a.ctx, true, a.attn, false);
        } else {
            if (warp == 0 && blk < 2 * B) kv_write_item<KV8>(a, l, blk);
            refill(P_QKV, l + 1);
        }
        grid_sync(a.sync, base + ++n_bar * GRID);  // wo's output written

        // 4. xn = LN1(x + attention output); relu(xn @ W1 + b1)
        mbar_wait(&bars[4 + (l & 1)], (l >> 1) & 1);
        layer_norm_rows(x_s, a.attn, ln(l, 0), ln(l, 1), xn_s, B);
        __syncthreads();
        if (item[P_FC1] >= 0) project<W8, D>(a, smem, P_FC1, l, item[P_FC1], xn_s, false, a.hdn, true);
        grid_sync(a.sync, base + ++n_bar * GRID);  // fc1's output written

        // 5. y2 = hdn @ W2 + b2, over all of K
        if (item[P_FC2] >= 0) project<W8, F>(a, smem, P_FC2, l, item[P_FC2], a.hdn, true, a.y2, false);
        else refill(P_FC1, l + 1);
        grid_sync(a.sync, base + ++n_bar * GRID);  // fc2's output written
    }
    if (blk == 0) layer_norm_rows(xn_s, a.y2, ln(a.L - 1, 2), ln(a.L - 1, 3), a.out, B);
}

template <bool W8, bool KV8>
cudaError_t launch(const StepArgs& a, cudaStream_t st) {
    const void* kern = reinterpret_cast<const void*>(step_kernel<W8, KV8>);
    static int resident = -1;  // blocks of this kernel the card holds at once
    if (resident < 0) {
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<W8>::SMEM);
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, step_kernel<W8, KV8>, THREADS, Layout<W8>::SMEM);
        resident = sms * per_sm;
    }
    if (resident < GRID) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {const_cast<StepArgs*>(&a)};
    const cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(GRID), dim3(THREADS), args, Layout<W8>::SMEM, st);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return e;
    }
    return counted(C_STEP);
}

}  // namespace step

}  // namespace

extern "C" {

int gsv_proj(const float* x, const void* w, const float* w_scale, const float* bias, float* y, void* part,
             int* tickets, int n_tickets, int B, int K, int N, int n_split, int int8, int relu, void* stream) {
    return static_cast<int>(launch_proj_any(int8, x, w, w_scale, bias, y, part, tickets, n_tickets, B, K, N,
                                            n_split, relu, static_cast<cudaStream_t>(stream)));
}

int gsv_decode_attn(const float* qkv, const void* kv, const float* kv_scales, const float* mask, float* part,
                    float* out, int* tickets, int n_tickets, int B, int H, int D, int T, int n_valid, int n_split,
                    float scale, int int8, void* stream) {
    return static_cast<int>(launch_attn(qkv, kv, kv_scales, mask, part, out, tickets, n_tickets, B, H, D, T, n_valid,
                                        n_split, scale, int8, static_cast<cudaStream_t>(stream)));
}

int gsv_add_layernorm(const float* x, const float* y, const float* scale, const float* bias, float* out, int B,
                      int D, void* stream) {
    return static_cast<int>(launch_ln(x, y, scale, bias, out, B, D, static_cast<cudaStream_t>(stream)));
}

// The whole step in one launch of step::step_kernel. w = {wqkv, wo, fc1,
// fc2} stacked K-major (L, N, K), bf16 or int8; w_s their (L, 1, N) scales
// (int8 only); vec = {bqkv, bo, n1s, n1b, n2s, n2b, b1, b2} (L, 1, N) f32.
// kv (L, B, T, 2D) and kv_scales (L, B, 2, T) are read over [0, write_idx)
// and the new token's K/V is written at write_idx. Scratch: qkv (B, 3D),
// ctx, attn, y2 (B, D), hdn (B, F). Attention cuts the prefix of each
// (row, head) into n_split = max(1, ceil(write_idx / (32 slot_r))) <= 128
// splits, slot_r 1, 2 or (int8 KV) 4. sync: the grid barrier's u32 count,
// zero before the first launch on it; every launch grows it by GRID a
// barrier. h (B, D) receives the output. D = 512, F = 2048, H = 16, B <= 8.
int gsv_decode_step(const float* x, float* h, const void* const* w, const float* const* w_s,
                    const float* const* vec, void* kv, float* kv_scales, const float* mask, float* qkv, float* ctx,
                    float* attn, float* hdn, float* y2, unsigned* sync, float scale, int L, int B, int T,
                    int write_idx, int n_split, int slot_r, int w_int8, int kv_int8, void* stream) {
    const bool r_ok = slot_r == 1 || slot_r == 2 || (slot_r == step::MAX_SLOT_R && kv_int8);
    if (B < 1 || B > step::ROWS || L < 1 || write_idx < 0 || write_idx >= T || n_split < 1 ||
        n_split > step::MAX_SPLITS || !r_ok || n_split * 32 * slot_r < write_idx)
        return static_cast<int>(cudaErrorInvalidValue);
    step::StepArgs a;
    a.x = x;
    a.out = h;
    for (int p = 0; p < 4; ++p) {
        a.w[p] = w[p];
        a.ws[p] = w_int8 ? w_s[p] : nullptr;
    }
    for (int j = 0; j < 8; ++j) a.vec[j] = vec[j];
    a.kv = kv;
    a.kv_scales = kv_scales;
    a.mask = mask;
    a.qkv = qkv;
    a.ctx = ctx;
    a.attn = attn;
    a.hdn = hdn;
    a.y2 = y2;
    a.sync = sync;
    a.scale = scale;
    a.L = L;
    a.B = B;
    a.T = T;
    a.n_valid = write_idx;
    a.n_split = n_split;
    a.slot_r = slot_r;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (w_int8)
        e = kv_int8 ? step::launch<true, true>(a, st) : step::launch<true, false>(a, st);
    else
        e = kv_int8 ? step::launch<false, true>(a, st) : step::launch<false, false>(a, st);
    return static_cast<int>(e);
}

// launches since the last reset: proj, decode_attn, add_layernorm, and the
// whole-step kernel
void gsv_launch_counts(long long* out) {
    for (int i = 0; i < C_COUNT; ++i) out[i] = g_launches[i];
}

void gsv_reset_launch_counts() {
    for (int i = 0; i < C_COUNT; ++i) g_launches[i] = 0;
}

}  // extern "C"
