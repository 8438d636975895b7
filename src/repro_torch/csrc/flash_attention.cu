// Causal flash attention for Hopper (sm_90a): the prefill kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_tpu (body _flash_kernel). Same contract: q (BH, S, hd)
// and k, v (BH / n_rep, S, hd), the q row bh reading KV row bh / n_rep (the
// GQA broadcast without a repeated copy); the tanh softcap; the mask (kpos
// < S, kpos <= qpos when causal, qpos - kpos < window when window > 0) to
// -1e30; an online softmax over key tiles with fp32 m, l and acc; out = acc
// / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: the work, 4 * hd flops per live (query, key)
// pair, about 8.6 GFLOP at a 1024-token gemma2-2b prefill of one layer
// (16 heads, hd 256, causal half), 8.7 us at the bf16 tensor-core rate;
// the bytes (q, k, v, out once, 21 MB) take 6.3 us at 3.35 TB/s.
//
// Two routes, one library; the wrapper picks one from the dtype before
// launching (kernels/flash_attention.py::flash_route):
//
// Tensor cores (flash_attention_tc): bf16, every launch of the bf16 serving
// path. attention_tc.cuh's body: Q K^T and P V on wgmma, softmax in the
// accumulators' registers. It computes the reference model's prefill
// (models/attention.py::flash_attention): the scale multiplies the bf16
// dot (at hd 64 and 256 a power of two, so bit-identical to scaling q
// first) and p is rounded to bf16 before P V. The producer's TMA reads K
// and V through 2-D maps over (KV * S, hd) in place: rows past S
// of one KV head are the next head's (finite, and masked), rows past the
// array are zero-filled; Q through a map over (BH * S, hd).
//
// CUDA cores (flash_attention_fwd): fp32 -- the small card-vs-CPU models --
// with the TPU kernel's arithmetic: the query scaled before the dot, p kept
// in fp32 for the value product.
//  * one block per (64-row query tile, bh); the query tile is staged once in
//    shared memory as fp32 (already scaled), key and value tiles of 32 rows
//    are staged in turn. At hd 256 that is 128 KB of shared memory, set with
//    cudaFuncSetAttribute above the 48 KB default;
//  * the TPU kernel's block skip: key tiles wholly above the causal diagonal
//    of the query tile, or wholly before its sliding window, are never
//    loaded. A skipped tile would only add -1e30 scores, whose weight is
//    exactly 0 once a row has met its first valid key (its own position);
//  * eight warps, eight query rows each. Lane j scores key j of the tile
//    against the warp's eight rows (float4 reads: the query rows broadcast,
//    the key rows padded by 4 floats so the lanes hit distinct banks); the
//    row max and sum are warp shuffles; for the value product lane j's
//    probabilities are broadcast by shuffle and each lane accumulates
//    hd / 32 dimensions of the eight rows in registers (at hd 16, the
//    smoke configs', lanes 0-15 one each and the others none);
//  * -1e30, never -inf, marks a masked score: a row whose every key in a
//    live tile is masked (a window, or a padded row past S) adds exp(0) to
//    l and v to acc, both wiped by corr = exp(-1e30 - m) = 0 at its first
//    valid key; -inf would give (-inf) - (-inf) = NaN;
//  * query rows past S are computed and not stored; key rows past S are
//    staged as zeros and masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr int BQ = 64;                 // query rows a block
constexpr int BK = 32;                 // key rows a tile (one per lane)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;        // query rows a warp
constexpr int KPAD = 4;                // floats of padding a staged key row
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage rows [r0, r0 + nrows) of a (rows, HD) matrix into shared memory as
// fp32 with row stride `ld`, times `mul`; rows at or past `limit` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int ld, const T* __restrict__ src,
                                      int r0, int nrows, int limit, float mul)
{
    constexpr int V = 16 / sizeof(T);  // elements of one 16-byte load
    for (int idx = threadIdx.x; idx < nrows * HD / V; idx += THREADS) {
        const int r = idx / (HD / V), c = (idx - r * (HD / V)) * V;
        float* d = dst + r * ld + c;
        if (r0 + r < limit) {
            const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
                src + (size_t)(r0 + r) * HD + c));
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int i = 0; i < V; ++i) d[i] = to_f(e[i]) * mul;
        } else {
#pragma unroll
            for (int i = 0; i < V; ++i) d[i] = 0.f;
        }
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, int S, int n_rep, int causal, int window,
          float softcap, float scale)
{
    constexpr int EPL = (HD + 31) / 32;  // value dimensions a lane accumulates
    const bool holds = HD >= 32 || (threadIdx.x & 31) < HD;  // lanes past hd: none
    extern __shared__ float smem[];
    float* sq = smem;                  // [BQ][HD]
    float* sk = sq + BQ * HD;          // [BK][HD + KPAD]
    float* sv = sk + BK * (HD + KPAD); // [BK][HD]

    const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* qb = q + (size_t)bh * S * HD;
    const T* kb = k + (size_t)(bh / n_rep) * S * HD;
    const T* vb = v + (size_t)(bh / n_rep) * S * HD;

    stage<T, HD>(sq, HD, qb, q0, BQ, S, scale);

    const int nk = (S + BK - 1) / BK;
    int kt_lo = 0, kt_hi = nk;
    if (causal) {
        kt_hi = min(nk, (q0 + BQ - 1) / BK + 1);
        if (window > 0) {
            const int lo = q0 - window + 2 - BK;   // first live tile start
            kt_lo = lo <= 0 ? 0 : (lo + BK - 1) / BK;
        }
    }

    float m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        m[r] = NEG;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }

    const int row0 = warp * RPW;
    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();               // previous tile fully consumed
        stage<T, HD>(sk, HD + KPAD, kb, k0, BK, S, 1.f);
        stage<T, HD>(sv, HD, vb, k0, BK, S, 1.f);
        __syncthreads();

        float s[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) s[r] = 0.f;
        const float* krow = sk + lane * (HD + KPAD);
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float4 qv = *reinterpret_cast<const float4*>(sq + (row0 + r) * HD + d);
                s[r] = fmaf(qv.x, kv.x, s[r]);
                s[r] = fmaf(qv.y, kv.y, s[r]);
                s[r] = fmaf(qv.z, kv.z, s[r]);
                s[r] = fmaf(qv.w, kv.w, s[r]);
            }
        }

        const int kpos = k0 + lane;
        float p[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int qpos = q0 + row0 + r;
            float x = s[r];
            if (softcap > 0.f) x = softcap * tanhf(x / softcap);
            bool valid = kpos < S;
            if (causal) valid = valid && qpos >= kpos;
            if (window > 0) valid = valid && qpos - kpos < window;
            x = valid ? x : NEG;
            float mx = x;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[r], mx);
            p[r] = expf(x - m_new);
            float ps = p[r];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
            const float corr = expf(m[r] - m_new);
            l[r] = l[r] * corr + ps;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
            m[r] = m_new;
        }

#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            float vr[EPL];
#pragma unroll
            for (int e = 0; e < EPL; ++e) vr[e] = holds ? sv[j * HD + lane + 32 * e] : 0.f;
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
                for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pj, vr[e], acc[r][e]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int t = q0 + row0 + r;
        if (t >= S || !holds) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        T* o = out + ((size_t)bh * S + t) * HD;
#pragma unroll
        for (int e = 0; e < EPL; ++e) store(o + lane + 32 * e, acc[r][e] * inv);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S,
           int n_rep, int causal, int window, float softcap, float scale,
           cudaStream_t s)
{
    const size_t smem = sizeof(float) * (BQ * HD + BK * (HD + KPAD) + BK * HD);
    static bool attr_set = false;      // once per instantiation
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    dim3 grid((S + BQ - 1) / BQ, BH);
    flash_fwd<T, HD><<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), S, n_rep, causal, window, softcap, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int HD, const void* q, const void* k, const void* v, void* out, int BH,
              int S, int n_rep, int causal, int window, float softcap, float scale,
              cudaStream_t s)
{
    switch (HD) {
        case 16: return launch<T, 16>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        case 64: return launch<T, 64>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        case 128: return launch<T, 128>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        case 256: return launch<T, 256>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// tensor-core route
// ---------------------------------------------------------------------------
// A block: slab rows [i0, i0 + 128) of KV head g's query slab (n_rep * S
// rows); one producer thread loads Q once, then the key tiles live for the
// block's positions into the ring; each consumer warpgroup attends its 64
// rows over them.
template <int HD>
__global__ void __launch_bounds__(attn::THREADS, 1)
flash_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
         int S, int n_rep, int causal, int window, float softcap, float scale)
{
    using R = attn::Ring<HD>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sq = hopper::align_1024(smem_raw);
    uint8_t* ring = sq + 2 * R::Q_WG;
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
    uint64_t* empty = full + R::STAGES;
    uint64_t* qbar = empty + R::STAGES;
    const int g = blockIdx.y, rows = n_rep * S, i0 = blockIdx.x * attn::BQ;
    const int nk = (S + attn::BK - 1) / attn::BK;
    int qlo, qhi;                              // the block's positions
    attn::span(i0, min(i0 + attn::BQ, rows) - 1, S, qlo, qhi);
    auto tile = [&](int kt) { return attn::Tile{kt * attn::BK, S - kt * attn::BK}; };

    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < R::STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 2);
        }
        hopper::mbar_init(qbar, 1);
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x >= 256) {
        attn::producer_regs();
        if (threadIdx.x == 256) {
            hopper::mbar_arrive_expect_tx(qbar, 2 * R::Q_WG);
#pragma unroll
            for (int w = 0; w < 2; ++w)
#pragma unroll
                for (int c = 0; c < HD / 64; ++c)
                    hopper::tma_load_2d(sq + w * R::Q_WG + c * attn::BOX, &tq, qbar,
                                        64 * c, g * rows + i0 + 64 * w);
            int it = 0;
            attn::for_tiles(nk, tile, qlo, qhi, causal, window, 0, 1, [&](int kt) {
                const int s = it % R::STAGES;
                if (it >= R::STAGES)
                    hopper::mbar_wait(&empty[s], ((it / R::STAGES) & 1) ^ 1);
                hopper::mbar_arrive_expect_tx(&full[s], R::STAGE);
                uint8_t* st = ring + s * R::STAGE;
#pragma unroll
                for (int c = 0; c < HD / 64; ++c) {
                    hopper::tma_load_2d(st + c * attn::BOX, &tk, &full[s], 64 * c,
                                        g * S + kt * attn::BK);
                    hopper::tma_load_2d(st + R::TILE + c * attn::BOX, &tv, &full[s],
                                        64 * c, g * S + kt * attn::BK);
                }
                ++it;
            });
        }
        return;
    }

    attn::consumer_regs();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, q = t % 4;
    const int w0 = i0 + 64 * wg;               // the warpgroup's first slab row
    int wlo, whi;
    attn::span(w0, min(w0 + 64, rows) - 1, S, wlo, whi);
    attn::Rows<HD> acc;
    acc.init();
    __nv_bfloat16* dst[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = w0 + 16 * (t / 32) + (t % 32) / 4 + 8 * h;
        acc.qpos[h] = i % S;
        dst[h] = i < rows ? out + ((size_t)g * rows + i) * HD : nullptr;
    }
    const uint32_t q_addr = hopper::smem_addr(sq + wg * R::Q_WG);
    const float sc = softcap > 0.f ? scale / softcap : scale;
    hopper::mbar_wait(qbar, 0);
    int it = 0;
    attn::for_tiles(nk, tile, qlo, qhi, causal, window, 0, 1, [&](int kt) {
        const int s = it % R::STAGES;
        hopper::mbar_wait(&full[s], (it / R::STAGES) & 1);
        const uint32_t k_addr = hopper::smem_addr(ring + s * R::STAGE);
        acc.step(q_addr, k_addr, k_addr + R::TILE, tile(kt), wlo, whi, q, causal,
                 window, sc, softcap);
        if (t == 0)
            hopper::mbar_arrive(&empty[s]);
        ++it;
    });
    acc.store(dst, q);
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int BH,
                      int S, int n_rep, int causal, int window, float softcap,
                      float scale, cudaStream_t s)
{
    using R = attn::Ring<HD>;
    const int KV = BH / n_rep;
    CUtensorMap tq, tk, tv;
    cudaError_t e = hopper::make_map(&tq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                     (uint64_t)BH * S, HD, 64);
    if (e == cudaSuccess)
        e = hopper::make_map(&tk, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             (uint64_t)KV * S, HD, 64);
    if (e == cudaSuccess)
        e = hopper::make_map(&tv, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             (uint64_t)KV * S, HD, 64);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(flash_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)R::SMEM);
    if (e != cudaSuccess)
        return e;
    const dim3 grid((n_rep * S + attn::BQ - 1) / attn::BQ, KV);
    flash_tc<HD><<<grid, attn::THREADS, R::SMEM, s>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, n_rep, causal, window, softcap,
        scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: (BH, S, HD); k, v: (BH / n_rep, S, HD); bf16 (is_bf16 = 1) or
// fp32, all alike. HD in {16, 64, 128, 256}. Returns cudaGetLastError()
// after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        int is_bf16, int BH, int S, int HD, int n_rep, int causal,
                        int window, float softcap, float scale, void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (S < 1 || BH < 1 || n_rep < 1 || BH % n_rep) return (int)cudaErrorInvalidValue;
    return is_bf16
        ? launch_hd<__nv_bfloat16>(HD, q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s)
        : launch_hd<float>(HD, q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
}

// The tensor-core route: q, out (BH, S, HD); k, v (BH / n_rep, S, HD); all
// bf16, contiguous, 16-byte aligned. HD in {64, 128, 256}. Returns
// cudaGetLastError() after the launch, or the error that kept it from one.
int flash_attention_tc(const void* q, const void* k, const void* v, void* out, int BH,
                       int S, int HD, int n_rep, int causal, int window, float softcap,
                       float scale, void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (S < 1 || BH < 1 || n_rep < 1 || BH % n_rep || BH / n_rep > 65535
        || (long long)BH * S >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    switch (HD) {
        case 64: return (int)launch_tc<64>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        case 128: return (int)launch_tc<128>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        case 256: return (int)launch_tc<256>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The tensor-core route's tiles (attn::export_tiles; out holds 11 ints).
int flash_attention_tc_tiles(int* out)
{
    return attn::export_tiles(out);
}

const char* flash_attention_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
