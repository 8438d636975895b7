// Causal flash attention for Hopper (sm_90a): the prefill kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_tpu (body _flash_kernel). Same contract: q (BH, S, hd)
// and k, v (BH / n_rep, S, hd), the q row bh reading KV row bh / n_rep (the
// GQA broadcast without a repeated copy); the query is scaled by 1/sqrt(hd)
// before the dot; then the tanh softcap; then the mask (kpos < S, kpos <=
// qpos when causal, qpos - kpos < window when window > 0) to -1e30; an online
// softmax over key tiles with fp32 m, l and acc, the probabilities kept in
// fp32 for the value product; out = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: the work, 4 * hd flops per live (query, key)
// pair, about 8.6 GFLOP at a 1024-token gemma2-2b prefill of one layer
// (16 heads, hd 256, causal half); the bytes (q, k, v, out once) are ~34 MB.
// This first kernel runs on the CUDA cores in fp32, as the TPU kernel's
// arithmetic is fp32, so it sits far above the bf16 tensor-core bound.
//
// Design:
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
//    hd / 32 dimensions of the eight rows in registers;
//  * -1e30, never -inf, marks a masked score: a row whose every key in a
//    live tile is masked (a window, or a padded row past S) adds exp(0) to
//    l and v to acc, both wiped by corr = exp(-1e30 - m) = 0 at its first
//    valid key; -inf would give (-inf) - (-inf) = NaN;
//  * query rows past S are computed and not stored; key rows past S are
//    staged as zeros and masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
    constexpr int EPL = HD / 32;       // value dimensions a lane accumulates
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
            for (int e = 0; e < EPL; ++e) vr[e] = sv[j * HD + lane + 32 * e];
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
        if (t >= S) continue;
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
        case 64: return launch<T, 64>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        case 128: return launch<T, 128>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        case 256: return launch<T, 256>(q, k, v, out, BH, S, n_rep, causal, window, softcap, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q, out: (BH, S, HD); k, v: (BH / n_rep, S, HD); bf16 (is_bf16 = 1) or
// fp32, all alike. HD in {64, 128, 256}. Returns cudaGetLastError() after
// the launch.
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

const char* flash_attention_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
