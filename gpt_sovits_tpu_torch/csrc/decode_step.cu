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
// above step::step_kernel has the details.
//
// Write slots: each row writes its new K/V at a slot of its own (the TPU
// kernel's (B,) write_idx, which continuous batching passes), and every
// row's attention sweeps the cache up to the largest of them, its mask
// choosing what each row attends to.
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
// C interface: the entry returns the error of its launch. Every launch
// that the runtime accepts adds one to the count (gsv_launch_counts), at the
// launch and nowhere else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;

// launch counts, in the order gsv_launch_counts reports them
enum Counter { C_STEP, C_COUNT };
long long g_launches[C_COUNT] = {};

// the error of the launch just made; counts it if the runtime took it
cudaError_t counted(Counter c) {
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++g_launches[c];
    return e;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

constexpr int DH = 32;        // head dim of every S1 configuration served
constexpr int PART = DH + 2;  // an attention split's partial: ctx[DH], max, sum

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
//      output), while 2B others write each row's new K/V into the cache at
//      the row's slot (quantized per token in int8-KV mode);
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
    int L, B, T;
    int slot[ROWS];       // the slot each row writes its new K/V at
    int n_valid;          // the attention's sweep: slots [0, max(slot))
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
// at the row's slot, as bf16, or as int8 codes with a per-token scale
// max(max|x|, ...) / 127 of the bf16 values (ops/decode_step.py _write_new_kv).
template <bool KV8>
__device__ void kv_write_item(const StepArgs& a, int layer, int j) {
    const int lane = threadIdx.x & 31, b = j >> 1, side = j & 1;
    const float* src = a.qkv + (size_t)b * 3 * D + D + side * D;
    const int slot = a.slot[b];
    const size_t dst = (((size_t)layer * a.B + b) * a.T + slot) * 2 * D + side * D;
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
        if (lane == 0) a.kv_scales[(((size_t)layer * a.B + b) * 2 + side) * a.T + slot] = s;
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
        // wo item write each row's new K/V into the cache at its slot
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

// The whole step in one launch of step::step_kernel. w = {wqkv, wo, fc1,
// fc2} stacked K-major (L, N, K), bf16 or int8; w_s their (L, 1, N) scales
// (int8 only); vec = {bqkv, bo, n1s, n1b, n2s, n2b, b1, b2} (L, 1, N) f32.
// slots (host, B ints): the slot each row writes its new K/V at, each in
// [0, T). kv (L, B, T, 2D) and kv_scales (L, B, 2, T) are read over
// [0, max(slots)) under mask (B, T), and row b's new K/V is written at
// slots[b]. Scratch: qkv (B, 3D), ctx, attn, y2 (B, D), hdn (B, F).
// Attention cuts the prefix of each (row, head) into n_split =
// max(1, ceil(max(slots) / (32 slot_r))) <= 128 splits, slot_r 1, 2 or
// (int8 KV) 4. sync: the grid barrier's u32 count, zero before the first
// launch on it; every launch grows it by GRID a barrier. h (B, D) receives
// the output. D = 512, F = 2048, H = 16, B <= 8.
int gsv_decode_step(const float* x, float* h, const void* const* w, const float* const* w_s,
                    const float* const* vec, void* kv, float* kv_scales, const float* mask, float* qkv, float* ctx,
                    float* attn, float* hdn, float* y2, unsigned* sync, float scale, int L, int B, int T,
                    const int* slots, int n_split, int slot_r, int w_int8, int kv_int8, void* stream) {
    const bool r_ok = slot_r == 1 || slot_r == 2 || (slot_r == step::MAX_SLOT_R && kv_int8);
    if (B < 1 || B > step::ROWS || L < 1 || n_split < 1 || n_split > step::MAX_SPLITS || !r_ok)
        return static_cast<int>(cudaErrorInvalidValue);
    int n_valid = 0;
    for (int b = 0; b < B; ++b) {
        if (slots[b] < 0 || slots[b] >= T) return static_cast<int>(cudaErrorInvalidValue);
        n_valid = slots[b] > n_valid ? slots[b] : n_valid;
    }
    if (n_split * 32 * slot_r < n_valid) return static_cast<int>(cudaErrorInvalidValue);
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
    for (int b = 0; b < step::ROWS; ++b) a.slot[b] = b < B ? slots[b] : 0;
    a.n_valid = n_valid;
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

// launches of the whole-step kernel since the last reset
void gsv_launch_counts(long long* out) {
    for (int i = 0; i < C_COUNT; ++i) out[i] = g_launches[i];
}

void gsv_reset_launch_counts() {
    for (int i = 0; i < C_COUNT; ++i) g_launches[i] = 0;
}

}  // extern "C"
