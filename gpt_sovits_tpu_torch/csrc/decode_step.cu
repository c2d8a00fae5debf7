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
// What this first version does about it: within a launch, little beyond
// reading each byte once. gsv_decode_step (at the end of this file), called
// once per token by the wrapper in ops/decode_step.py, loops over the L
// layers and launches per layer
//   proj (qkv) -> decode_attn -> proj (wo) -> add_layernorm
//   -> proj (fc1, relu) -> proj (fc2) -> add_layernorm
// i.e. 7 kernel launches a layer, 168 per token at L=24, each a few
// microseconds long. So the step is launch-bound, not bandwidth-bound;
// capturing it in a CUDA graph, and a
// persistent whole-step kernel, are later work. proj reads W in 16- or
// 8-byte vectors with several loads in flight per lane and splits K across
// blocks so that each projection spreads over 32-128 SMs; decode_attn reads
// the live KV prefix once per (row, head) in flash-decoding splits.
//
// Numerics follow the TPU kernel:
//   * bf16 mode: bf16 operands, f32 accumulation; probabilities cast to bf16
//     before P@V.
//   * W8A8: per-row activation scale xs = max(max|x|, 1e-6) / 127,
//     round-half-even(x * (1 / xs)) clipped to +-127, s8 x s8 -> s32, then
//     * xs * w_scale[n].
//   * int8 KV: q quantized per head, scores rescaled by the K scales, probs
//     multiplied by the V scales and quantized per head per split (the TPU
//     kernel quantizes per VMEM chunk, so the two agree to rounding only).
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

// The whole step: the layer loop of ops/decode_step.py `_step_plain` on the
// kernels above, 7 launches a layer, from one host call. Weights are the
// stacked (L, ...) tensors: w = {wqkv, wo, fc1, fc2} (bf16 or int8),
// w_s = their (L, 1, N) scales (int8 only), vec = {bqkv, bo, n1s, n1b, n2s,
// n2b, b1, b2} (L, 1, N) f32. kv (L, B, T, 2D) and kv_scales (L, B, 2, T)
// are read only. Scratch: qkv (L, B, 3D) keeps every layer's projection for
// the caller's K/V write; ctx, a, xn, y2 (B, D) and hdn (B, F) are reused
// by every layer; h (B, D) receives the hidden state (LN2 rewrites it in
// place from layer 1 on: the layer input is dead once LN1 has read it).
int gsv_decode_step(const float* x, float* h, const void* const* w, const float* const* w_s,
                    const float* const* vec, const void* kv, const float* kv_scales, const float* mask, float* qkv,
                    float* ctx, float* a, float* xn, float* hdn, float* y2, void* part, float* apart, int* tickets,
                    int n_tickets, const int* proj_splits, int attn_splits, float scale, int L, int B, int D, int F,
                    int H, int T, int write_idx, int w_int8, int kv_int8, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int K[4] = {D, D, D, F}, N[4] = {3 * D, D, F, D};
    const int vec_n[8] = {3 * D, D, D, D, D, D, F, D};
    const size_t w_elt = w_int8 ? 1 : 2, kv_layer = (size_t)B * T * 2 * D * (kv_int8 ? 1 : 2);
    auto at = [](const void* base, size_t layer_bytes, int l) {
        return static_cast<const char*>(base) + (size_t)l * layer_bytes;
    };
    auto v = [&](int j, int l) { return vec[j] + (size_t)l * vec_n[j]; };
    auto proj = [&](int p, int l, const float* in, float* out, int relu) {
        return launch_proj_any(w_int8, in, at(w[p], (size_t)K[p] * N[p] * w_elt, l),
                               w_int8 ? w_s[p] + (size_t)l * N[p] : nullptr, v(p == 0 ? 0 : p == 1 ? 1 : p + 4, l),
                               out, part, tickets, n_tickets, B, K[p], N[p], proj_splits[p], relu, st);
    };
#define GSV_TRY(expr)                                   \
    do {                                                \
        const cudaError_t e_ = (expr);                  \
        if (e_ != cudaSuccess) return static_cast<int>(e_); \
    } while (0)
    const float* xin = x;
    for (int l = 0; l < L; ++l) {
        float* q = qkv + (size_t)l * B * 3 * D;
        GSV_TRY(proj(0, l, xin, q, 0));
        GSV_TRY(launch_attn(q, at(kv, kv_layer, l), kv_int8 ? kv_scales + (size_t)l * B * 2 * T : nullptr, mask,
                            apart, ctx, tickets, n_tickets, B, H, D, T, write_idx, attn_splits, scale, kv_int8, st));
        GSV_TRY(proj(1, l, ctx, a, 0));
        GSV_TRY(launch_ln(xin, a, v(2, l), v(3, l), xn, B, D, st));
        GSV_TRY(proj(2, l, xn, hdn, 1));
        GSV_TRY(proj(3, l, hdn, y2, 0));
        GSV_TRY(launch_ln(xn, y2, v(4, l), v(5, l), h, B, D, st));
        xin = h;
    }
#undef GSV_TRY
    ++g_launches[C_STEP];
    return 0;
}

// launches since the last reset: proj, decode_attn, add_layernorm, and the
// whole steps that gsv_decode_step ran
void gsv_launch_counts(long long* out) {
    for (int i = 0; i < C_COUNT; ++i) out[i] = g_launches[i];
}

void gsv_reset_launch_counts() {
    for (int i = 0; i < C_COUNT; ++i) g_launches[i] = 0;
}

}  // extern "C"
