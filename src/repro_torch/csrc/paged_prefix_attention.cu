// Paged prefix attention for Hopper (sm_90a): the prefix-cache tail prefill.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_prefix_attention (body _prefix_kernel). Same contract: the tail's
// queries q (H, T, hd), at absolute positions offset + t, attend over
// [the cached prefix's pool pages, read in place by page_ids ; the tail's
// own K/V rows (S, KV, hd)]; query head h reads KV head h / n_rep. Prefix
// row r sits at position r and is valid below prefix_len; tail row j sits
// at offset + j and is valid below length. Mask: valid & kpos <= qpos (&
// qpos - kpos < window). Scores are dot(q, k) * 1/sqrt(hd), then the tanh
// softcap, then -1e30 where masked; an online softmax with fp32 m, l and
// acc; the probabilities are cast to v's dtype before the value product, as
// flash_attention_abs does; the output is acc / max(l, 1e-30) in fp32.
// Int8 prefix rows take gather_prefix_kv's chain: int8 -> fp32 * scale ->
// the tail's dtype (bf16 on the card) -> fp32 for the dot.
//
// What bounds it on the H100: the work, 4 * hd flops per live (query, key)
// pair -- a 256-row tail over a 512-row prefix is 16 heads x 256 x ~640
// keys x 1 KFLOP = 2.7 GFLOP at hd 256 -- against ~5 MB of bytes. Like the
// prefill kernel it runs on the CUDA cores in fp32.
//
// Design:
//  * the TPU kernel stages the whole [prefix ; tail] window in VMEM. At hd
//    256 a 512-row prefix plus a 256-row tail is 384 KB of K alone, above
//    the 227 KB of shared memory a block can have. So K and V stream through
//    the online softmax in tiles of 32 rows, as csrc/flash_attention.cu
//    does: one block per (64-row query tile, query head), the query tile
//    staged once in shared memory (fp32);
//  * only the ceil(prefix_len / page) live prefix pages are read; entries
//    of page_ids past them (garbage page 0 in a bucketed call) never are.
//    The rows of the combined window are [0, n_live * page) from the pool
//    and then the S tail rows;
//  * a key tile is skipped when every one of its rows is masked for every
//    query of the block: all past the block's last position, all before its
//    window, or all past prefix_len / length. As in the prefill kernel, a
//    skipped tile would only add scores of weight exactly 0 to a row that
//    has a valid key;
//  * lane j scores key j of the tile against the warp's eight query rows;
//    the probabilities are broadcast by shuffle for the value product, each
//    lane accumulating hd / 32 dimensions of the eight rows;
//  * query rows past T are computed and not stored; key rows past the
//    window are staged as zeros and masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;
constexpr int KPAD = 4;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
// round an fp32 value to T and back: the cast to the tail's dtype
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16)
{
    return __bfloat162float(__float2bfloat16(x));
}

// Stage 16 bytes of one row: `src` points at element c of the row.
template <typename P, typename T>
__device__ __forceinline__ void stage_chunk(float* d, const P* __restrict__ src, float scale,
                                            bool quant)
{
    constexpr int V = 16 / sizeof(P);
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const P* e = reinterpret_cast<const P*>(&raw);
    if (quant) {
#pragma unroll
        for (int i = 0; i < V; ++i) d[i] = round_to(to_f(e[i]) * scale, T());
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) d[i] = to_f(e[i]);
    }
}

// Stage key or value rows [k0, k0 + BK) of the combined window into `dst`
// (row stride ld, fp32). Rows below np come from the pool pages, the next S
// from the tail; the rest are zeros. P is the pool's element type, T the
// tail's (and the model's) dtype.
template <typename P, typename T, int HD>
__device__ __forceinline__ void stage_window(
    float* dst, int ld, const P* __restrict__ pool, const float* __restrict__ pscale,
    const T* __restrict__ tail, const int32_t* __restrict__ page_ids, int k0, int np,
    int S, int page, int KV, int g)
{
    constexpr bool QUANT = sizeof(P) == 1;
    constexpr int VP = 16 / sizeof(P);          // pool elements a 16-byte load
    constexpr int VT = 16 / sizeof(T);
    // pool rows: chunks of VP elements
    for (int idx = threadIdx.x; idx < BK * (HD / VP); idx += THREADS) {
        const int r = idx / (HD / VP), c = (idx - r * (HD / VP)) * VP;
        const int row = k0 + r;
        if (row >= np) continue;
        const int pid = page_ids[row / page];
        const size_t cell = ((size_t)pid * page + (row % page)) * KV + g;
        stage_chunk<P, T>(dst + r * ld + c, pool + cell * HD + c,
                          QUANT ? pscale[cell] : 1.f, QUANT);
    }
    // tail rows and zeros
    for (int idx = threadIdx.x; idx < BK * (HD / VT); idx += THREADS) {
        const int r = idx / (HD / VT), c = (idx - r * (HD / VT)) * VT;
        const int row = k0 + r;
        if (row < np) continue;
        float* d = dst + r * ld + c;
        const int j = row - np;
        if (j < S) {
            stage_chunk<T, T>(d, tail + ((size_t)j * KV + g) * HD + c, 1.f, false);
        } else {
#pragma unroll
            for (int i = 0; i < VT; ++i) d[i] = 0.f;
        }
    }
}

template <typename P, typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
prefix_fwd(const T* __restrict__ q, const T* __restrict__ kt, const T* __restrict__ vt,
           const P* __restrict__ kpool, const P* __restrict__ vpool,
           const float* __restrict__ kscale, const float* __restrict__ vscale,
           const int32_t* __restrict__ page_ids, float* __restrict__ out, int T_, int S,
           int KV, int n_rep, int page, int npp, int offset, int prefix_len, int length,
           int window, float softcap, float scale)
{
    constexpr int EPL = HD / 32;
    extern __shared__ float smem[];
    float* sq = smem;                   // [BQ][HD]
    float* sk = sq + BQ * HD;           // [BK][HD + KPAD]
    float* sv = sk + BK * (HD + KPAD);  // [BK][HD]

    const int t0 = blockIdx.x * BQ, h = blockIdx.y, g = h / n_rep;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    // stage the query tile (fp32, unscaled: the scale follows the dot)
    {
        constexpr int VT = 16 / sizeof(T);
        const T* qb = q + (size_t)h * T_ * HD;
        for (int idx = threadIdx.x; idx < BQ * (HD / VT); idx += THREADS) {
            const int r = idx / (HD / VT), c = (idx - r * (HD / VT)) * VT;
            float* d = sq + r * HD + c;
            if (t0 + r < T_) {
                stage_chunk<T, T>(d, qb + (size_t)(t0 + r) * HD + c, 1.f, false);
            } else {
#pragma unroll
                for (int i = 0; i < VT; ++i) d[i] = 0.f;
            }
        }
    }

    const int n_live = min(npp, (prefix_len + page - 1) / page);
    const int np = n_live * page;
    const int nrows = np + S;
    const int q_lo = offset + t0, q_hi = offset + min(t0 + BQ, T_) - 1;

    float m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        m[r] = NEG;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }

    const int row0 = warp * RPW;
    for (int k0 = 0; k0 < nrows; k0 += BK) {
        // block skip: every row of the tile masked for every query here?
        const int k1 = min(k0 + BK, nrows) - 1;
        bool live = false;
        if (k0 < np) {                  // prefix rows [k0, min(k1, np - 1)]
            const int a = k0, b = min(k1, np - 1);
            live |= a < prefix_len && a <= q_hi && (window <= 0 || b > q_lo - window);
        }
        if (k1 >= np) {                 // tail rows j in [ja, jb]
            const int ja = max(k0, np) - np, jb = k1 - np;
            live |= ja < length && offset + ja <= q_hi
                    && (window <= 0 || offset + jb > q_lo - window);
        }
        if (!live) continue;

        __syncthreads();
        stage_window<P, T, HD>(sk, HD + KPAD, kpool, kscale, kt, page_ids, k0, np, S,
                               page, KV, g);
        stage_window<P, T, HD>(sv, HD, vpool, vscale, vt, page_ids, k0, np, S, page,
                               KV, g);
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

        const int row = k0 + lane;
        const bool in_prefix = row < np;
        const int kpos = in_prefix ? row : offset + (row - np);
        const bool kval = in_prefix ? row < prefix_len : (row - np) < length && row < nrows;
        float p[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int qpos = offset + t0 + row0 + r;
            float x = s[r] * scale;
            if (softcap > 0.f) x = softcap * tanhf(x / softcap);
            bool valid = kval && kpos <= qpos;
            if (window > 0) valid = valid && qpos - kpos < window;
            x = valid ? x : NEG;
            float mx = x;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[r], mx);
            const float pe = expf(x - m_new);
            float ps = pe;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
            const float corr = expf(m[r] - m_new);
            l[r] = l[r] * corr + ps;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
            m[r] = m_new;
            p[r] = round_to(pe, T());  // p.astype(v.dtype) before the product
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
        const int t = t0 + row0 + r;
        if (t >= T_) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        float* o = out + ((size_t)h * T_ + t) * HD;
#pragma unroll
        for (int e = 0; e < EPL; ++e) o[lane + 32 * e] = acc[r][e] * inv;
    }
}

struct Args {
    const void *q, *kt, *vt, *kpool, *vpool;
    const float *kscale, *vscale;
    const int32_t* page_ids;
    float* out;
    int H, T, S, KV, n_rep, page, npp, offset, prefix_len, length, window;
    float softcap, scale;
};

template <typename P, typename T, int HD>
int launch(const Args& a, cudaStream_t s)
{
    const size_t smem = sizeof(float) * (BQ * HD + BK * (HD + KPAD) + BK * HD);
    static bool attr_set = false;      // once per instantiation
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            prefix_fwd<P, T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    dim3 grid((a.T + BQ - 1) / BQ, a.H);
    prefix_fwd<P, T, HD><<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.kt),
        static_cast<const T*>(a.vt), static_cast<const P*>(a.kpool),
        static_cast<const P*>(a.vpool), a.kscale, a.vscale, a.page_ids, a.out, a.T,
        a.S, a.KV, a.n_rep, a.page, a.npp, a.offset, a.prefix_len, a.length, a.window,
        a.softcap, a.scale);
    return (int)cudaGetLastError();
}

template <typename P, typename T>
int launch_hd(int HD, const Args& a, cudaStream_t s)
{
    switch (HD) {
        case 64: return launch<P, T, 64>(a, s);
        case 128: return launch<P, T, 128>(a, s);
        case 256: return launch<P, T, 256>(a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q: (H, T, HD); k_tail, v_tail: (S, KV, HD); pools: (n_pages, page, KV,
// HD); scales (n_pages, page, KV) fp32 when pool_int8 (else ignored);
// page_ids: (npp,) int32; out: (H, T, HD) fp32. q and the tail are bf16
// (is_bf16 = 1) or fp32; the pools are int8 (pool_int8 = 1) or the tail's
// dtype. HD in {64, 128, 256}; H = KV * n_rep. Returns cudaGetLastError().
int paged_prefix_attention(const void* q, const void* k_tail, const void* v_tail,
                           const void* k_pool, const void* v_pool, const float* k_scale,
                           const float* v_scale, const int32_t* page_ids, float* out,
                           int is_bf16, int pool_int8, int H, int T, int S, int KV,
                           int HD, int n_rep, int page, int npp, int offset,
                           int prefix_len, int length, int window, float softcap,
                           float scale, void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (T < 1 || S < 1 || KV < 1 || n_rep < 1 || H != KV * n_rep || page < 1)
        return (int)cudaErrorInvalidValue;
    const Args a{q, k_tail, v_tail, k_pool, v_pool, k_scale, v_scale, page_ids, out,
                 H, T, S, KV, n_rep, page, npp, offset, prefix_len, length, window,
                 softcap, scale};
    if (is_bf16)
        return pool_int8 ? launch_hd<int8_t, __nv_bfloat16>(HD, a, s)
                         : launch_hd<__nv_bfloat16, __nv_bfloat16>(HD, a, s);
    return pool_int8 ? launch_hd<int8_t, float>(HD, a, s)
                     : launch_hd<float, float>(HD, a, s);
}

const char* paged_prefix_attention_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
