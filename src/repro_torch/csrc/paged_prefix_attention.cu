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
// keys x 1 KFLOP = 2.7 GFLOP at hd 256, 2.8 us at the bf16 tensor-core
// rate -- against ~5 MB of bytes.
//
// Two routes, one library; the wrapper picks one from dtype, head dim and
// page size before launching (kernels/paged_attention.py::prefix_route):
//
// Tensor cores (paged_prefix_attention_tc): bf16 q and tail, bf16 or int8
// pools, pages of a power of two >= 8 rows -- every launch of the bf16
// serving path. attention_tc.cuh's body, with p rounded to bf16 as the
// reference does, so wgmma multiplies exactly the reference's operands. The
// key window is a run of prefix tiles, then a run of tail tiles, 64 rows
// each:
//  * prefix tiles hold the ceil(prefix_len / page) live pages in order;
//    entries of page_ids past them (garbage page 0 in a bucketed call)
//    never are read. The rows of a last tile past the live pages repeat the
//    last live page (finite, and masked: they sit at or past prefix_len);
//  * bf16 pools: one TMA box a page (or 64 rows of a longer page) and 64
//    columns, through a 3-D map over (pool rows, KV, hd), the 16-row page
//    of KV head g read in place at stride KV * hd;
//  * int8 pools: the producer warpgroup reads each row's codes (16-byte
//    loads, four in flight a thread) and its fp32 scale and writes
//    bf16(code * scale) into the swizzled tile -- gather_prefix_kv's
//    values, so the wgmma operands are the reference's -- then fences the
//    writes for wgmma and arrives;
//  * tail tiles: TMA through a 3-D map over (S, KV, hd), rows past S
//    zero-filled.
//
// CUDA cores (paged_prefix_attention): fp32 -- the small card-vs-CPU
// models -- and pages TMA cannot box.
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

#include "attention_tc.cuh"

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
    constexpr int EPL = (HD + 31) / 32;  // value dimensions a lane accumulates
    const bool holds = HD >= 32 || (threadIdx.x & 31) < HD;  // lanes past hd: none
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
        const int t = t0 + row0 + r;
        if (t >= T_ || !holds) continue;
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
        case 16: return launch<P, T, 16>(a, s);
        case 64: return launch<P, T, 64>(a, s);
        case 128: return launch<P, T, 128>(a, s);
        case 256: return launch<P, T, 256>(a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// tensor-core route
// ---------------------------------------------------------------------------
struct TcArgs {
    const int8_t *kp8, *vp8;              // int8 pools (QUANT)
    const float *kscale, *vscale;
    const int32_t* page_ids;
    float* out;
    float *part_o, *part_ml;              // the shares' rows, when nsplit > 1
    int nsplit, T, S, KV, n_rep, page, npp, offset, prefix_len, length, window;
    float softcap, scale;
};

// The producer warpgroup's int8 prefix tile: rows [k0, k0 + 64) of the
// window's prefix (np live rows), K and V, written as bf16(code * scale)
// into the stage's 128-byte-swizzled boxes; rows past np as zeros. p is the
// thread in the warpgroup; pid_l: lane c of each warp holds the page of
// rows k0 + c * pr.
template <int HD>
__device__ __forceinline__ void convert_tile(uint8_t* stage, const TcArgs& a, int g,
                                             int k0, int np, int pr, int pid_l, int p)
{
    using R = attn::Ring<HD>;
    constexpr int C16 = HD / 16;           // 16-code chunks a row
    constexpr int ITEMS = 2 * attn::BK * C16;
    // loads in flight a thread (four spill at head dim 64 in the producer's
    // 56 registers)
    constexpr int U = HD == 64 ? 2 : 4;
    static_assert(ITEMS % (128 * U) == 0, "items must split evenly");
    for (int b = 0; b < ITEMS; b += 128 * U) {
        uint4 raw[U];
        float sc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int idx = b + 128 * u + p;
            const int which = idx / (attn::BK * C16), rem = idx % (attn::BK * C16);
            const int r = rem / C16, c = rem % C16, row = k0 + r;
            const int pid = __shfl_sync(0xffffffffu, pid_l, r / pr);
            raw[u] = make_uint4(0, 0, 0, 0);
            sc[u] = 0.f;
            if (row < np) {
                const size_t cell = ((size_t)pid * a.page + row % a.page) * a.KV + g;
                const int8_t* pool = which ? a.vp8 : a.kp8;
                raw[u] = __ldg(reinterpret_cast<const uint4*>(pool + cell * HD + 16 * c));
                sc[u] = __ldg((which ? a.vscale : a.kscale) + cell);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int idx = b + 128 * u + p;
            const int which = idx / (attn::BK * C16), rem = idx % (attn::BK * C16);
            const int r = rem / C16, c = rem % C16;
            const int8_t* e = reinterpret_cast<const int8_t*>(&raw[u]);
            uint32_t w[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                w[i] = attn::bf16_pair((float)e[2 * i] * sc[u], (float)e[2 * i + 1] * sc[u]);
            // codes 16c .. 16c+15: box c / 4, 16-byte groups 2 (c % 4) and
            // the next, swizzled by the row
            uint8_t* row_p = stage + which * R::TILE + (c / 4) * attn::BOX + r * 128;
            const int grp = 2 * (c % 4);
            *reinterpret_cast<uint4*>(row_p + ((grp ^ (r & 7)) << 4)) =
                make_uint4(w[0], w[1], w[2], w[3]);
            *reinterpret_cast<uint4*>(row_p + (((grp + 1) ^ (r & 7)) << 4)) =
                make_uint4(w[4], w[5], w[6], w[7]);
        }
    }
}

// A block: slab rows [i0, i0 + 128) of KV head g's query slab (n_rep * T
// rows); prefix tiles kt < n_pt, then tail tiles; the producer warpgroup
// loads Q, then every tile live for the block's positions.
template <int HD, bool QUANT>
__global__ void __launch_bounds__(attn::THREADS, 1)
prefix_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tkt,
          const __grid_constant__ CUtensorMap tvt, const __grid_constant__ CUtensorMap tkp,
          const __grid_constant__ CUtensorMap tvp, const TcArgs a)
{
    using R = attn::Ring<HD>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sq = hopper::align_1024(smem_raw);
    uint8_t* ring = sq + 2 * R::Q_WG;
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
    uint64_t* empty = full + R::STAGES;
    uint64_t* qbar = empty + R::STAGES;
    const int g = blockIdx.y, rows = a.n_rep * a.T, i0 = blockIdx.x * attn::BQ;
    const int n_live = min(a.npp, (a.prefix_len + a.page - 1) / a.page);
    const int np = n_live * a.page;
    const int n_pt = (np + attn::BK - 1) / attn::BK;
    const int nk = n_pt + (a.S + attn::BK - 1) / attn::BK;
    int qlo, qhi;                              // the block's positions
    attn::span(i0, min(i0 + attn::BQ, rows) - 1, a.T, qlo, qhi);
    auto tile = [&](int kt) {
        if (kt < n_pt)
            return attn::Tile{kt * attn::BK, a.prefix_len - kt * attn::BK};
        const int j0 = (kt - n_pt) * attn::BK;
        return attn::Tile{a.offset + j0, a.length - j0};
    };

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
        // thread 0 of the warpgroup issues the TMA; the whole warpgroup
        // converts int8 pages (and keeps in step with it, named barrier 1)
        attn::producer_regs();
        const int p = threadIdx.x - 256, lane = p % 32;
        if (!QUANT && p != 0)
            return;
        const int pr = min(a.page, attn::BK);  // rows a page box
        if (p == 0) {
            hopper::mbar_arrive_expect_tx(qbar, 2 * R::Q_WG);
#pragma unroll
            for (int w = 0; w < 2; ++w)
#pragma unroll
                for (int c = 0; c < HD / 64; ++c)
                    hopper::tma_load_2d(sq + w * R::Q_WG + c * attn::BOX, &tq, qbar,
                                        64 * c, g * rows + i0 + 64 * w);
        }
        int it = 0;
        attn::for_tiles(nk, tile, qlo + a.offset, qhi + a.offset, true, a.window,
                        blockIdx.z, a.nsplit, [&](int kt) {
            const int s = it % R::STAGES;
            if (it >= R::STAGES)
                hopper::mbar_wait(&empty[s], ((it / R::STAGES) & 1) ^ 1);
            uint8_t* st = ring + s * R::STAGE;
            const int k0 = kt * attn::BK;
            if (kt >= n_pt) {                  // tail rows, TMA
                if (p == 0) {
                    hopper::mbar_arrive_expect_tx(&full[s], R::STAGE);
                    const int j0 = (kt - n_pt) * attn::BK;
#pragma unroll
                    for (int c = 0; c < HD / 64; ++c) {
                        hopper::tma_load_3d(st + c * attn::BOX, &tkt, &full[s], 64 * c, g, j0);
                        hopper::tma_load_3d(st + R::TILE + c * attn::BOX, &tvt, &full[s],
                                            64 * c, g, j0);
                    }
                }
            } else if constexpr (!QUANT) {     // bf16 pool pages, TMA
                if (p == 0) {
                    hopper::mbar_arrive_expect_tx(&full[s], R::STAGE);
                    for (int ch = 0; ch < attn::BK / pr; ++ch) {
                        const int row = k0 + ch * pr;
                        const int pid = a.page_ids[row < np ? row / a.page : n_live - 1];
                        const int prow = pid * a.page + (row < np ? row % a.page : 0);
#pragma unroll
                        for (int c = 0; c < HD / 64; ++c) {
                            const uint32_t off = c * attn::BOX + ch * pr * 128;
                            hopper::tma_load_3d(st + off, &tkp, &full[s], 64 * c, g, prow);
                            hopper::tma_load_3d(st + R::TILE + off, &tvp, &full[s], 64 * c,
                                                g, prow);
                        }
                    }
                }
            } else {                           // int8 pool pages, converted
                const int pid_l = lane < attn::BK / pr && k0 + lane * pr < np
                    ? a.page_ids[(k0 + lane * pr) / a.page] : 0;
                convert_tile<HD>(st, a, g, k0, np, pr, pid_l, p);
                hopper::fence_proxy_async();
                asm volatile("bar.sync 1, 128;\n" ::: "memory");
                if (p == 0)
                    hopper::mbar_arrive(&full[s]);
            }
            if constexpr (QUANT)
                asm volatile("bar.sync 1, 128;\n" ::: "memory");
            ++it;
        });
        return;
    }

    attn::consumer_regs();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, q = t % 4;
    const int w0 = i0 + 64 * wg;               // the warpgroup's first slab row
    int wlo, whi;
    attn::span(w0, min(w0 + 64, rows) - 1, a.T, wlo, whi);
    attn::Rows<HD> acc;
    acc.init();
    // out rows, or with shares this share's rows of part_o and part_ml
    const size_t HT = (size_t)a.KV * rows;
    float* o_base = a.nsplit > 1 ? a.part_o + blockIdx.z * HT * HD : a.out;
    float *dst[2], *ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = w0 + 16 * (t / 32) + (t % 32) / 4 + 8 * h;
        const size_t r = (size_t)g * rows + i;
        acc.qpos[h] = a.offset + i % a.T;
        dst[h] = i < rows ? o_base + r * HD : nullptr;
        ml[h] = a.nsplit > 1 ? a.part_ml + (blockIdx.z * HT + r) * 2 : nullptr;
    }
    const uint32_t q_addr = hopper::smem_addr(sq + wg * R::Q_WG);
    const float sc = a.softcap > 0.f ? a.scale / a.softcap : a.scale;
    hopper::mbar_wait(qbar, 0);
    int it = 0;
    attn::for_tiles(nk, tile, qlo + a.offset, qhi + a.offset, true, a.window,
                    blockIdx.z, a.nsplit, [&](int kt) {
        const int s = it % R::STAGES;
        hopper::mbar_wait(&full[s], (it / R::STAGES) & 1);
        const uint32_t k_addr = hopper::smem_addr(ring + s * R::STAGE);
        acc.step(q_addr, k_addr, k_addr + R::TILE, tile(kt), wlo + a.offset,
                 whi + a.offset, q, true, a.window, sc, a.softcap);
        if (t == 0)
            hopper::mbar_arrive(&empty[s]);
        ++it;
    });
    if (a.nsplit > 1)
        acc.store_partial(dst, ml, q);
    else
        acc.store(dst, q);
}

// out row r = sum_z w_z acc_z / max(sum_z w_z l_z, 1e-30), w_z = exp(m_z -
// M), M the largest m_z: the shares' rows merged in share order. A share
// whose every key was masked for the row (m_z = -1e30) weighs exactly 0.
template <int HD>
__global__ void __launch_bounds__(64)
prefix_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
               float* __restrict__ out, int rows, int nsplit)
{
    constexpr int E = HD / 64;                 // elements a thread
    const size_t r = blockIdx.x;
    float M = attn::NEG;
    for (int z = 0; z < nsplit; ++z)
        M = fmaxf(M, part_ml[(z * (size_t)rows + r) * 2]);
    float L = 0.f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int z = 0; z < nsplit; ++z) {
        const float* ml = part_ml + (z * (size_t)rows + r) * 2;
        const float w = expf(ml[0] - M);
        L += w * ml[1];
        const float* o = part_o + (z * (size_t)rows + r) * HD + threadIdx.x * E;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += w * o[e];
    }
    L = fmaxf(L, 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) out[r * HD + threadIdx.x * E + e] = acc[e] / L;
}

template <int HD, bool QUANT>
cudaError_t launch_tc(const void* q, const void* k_tail, const void* v_tail,
                      const void* k_pool, const void* v_pool, int n_pages, const TcArgs& a,
                      cudaStream_t s)
{
    using R = attn::Ring<HD>;
    const auto kernel = prefix_tc<HD, QUANT>;
    const int H = a.KV * a.n_rep;
    CUtensorMap tq, tkt, tvt, tkp, tvp;
    cudaError_t e = hopper::make_map(&tq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                     (uint64_t)H * a.T, HD, 64);
    if (e == cudaSuccess)
        e = hopper::make_map_3d(&tkt, k_tail, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.S,
                                a.KV, HD, attn::BK);
    if (e == cudaSuccess)
        e = hopper::make_map_3d(&tvt, v_tail, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.S,
                                a.KV, HD, attn::BK);
    tkp = tkt;                                 // unused by the int8 kernel
    tvp = tvt;
    if (e == cudaSuccess && !QUANT)
        e = hopper::make_map_3d(&tkp, k_pool, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                (uint64_t)n_pages * a.page, a.KV, HD,
                                (uint32_t)min(a.page, attn::BK));
    if (e == cudaSuccess && !QUANT)
        e = hopper::make_map_3d(&tvp, v_pool, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                (uint64_t)n_pages * a.page, a.KV, HD,
                                (uint32_t)min(a.page, attn::BK));
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)R::SMEM);
    if (e != cudaSuccess)
        return e;
    const dim3 grid((a.n_rep * a.T + attn::BQ - 1) / attn::BQ, a.KV, a.nsplit);
    kernel<<<grid, attn::THREADS, R::SMEM, s>>>(tq, tkt, tvt, tkp, tvp, a);
    if (a.nsplit > 1) {
        e = cudaGetLastError();
        if (e != cudaSuccess)
            return e;
        prefix_combine<HD><<<H * a.T, 64, 0, s>>>(a.part_o, a.part_ml, a.out, H * a.T,
                                                   a.nsplit);
    }
    return cudaGetLastError();
}

template <bool QUANT>
cudaError_t launch_tc_hd(int HD, const void* q, const void* kt, const void* vt,
                         const void* kp, const void* vp, int n_pages, const TcArgs& a,
                         cudaStream_t s)
{
    switch (HD) {
        case 64: return launch_tc<64, QUANT>(q, kt, vt, kp, vp, n_pages, a, s);
        case 128: return launch_tc<128, QUANT>(q, kt, vt, kp, vp, n_pages, a, s);
        case 256: return launch_tc<256, QUANT>(q, kt, vt, kp, vp, n_pages, a, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q: (H, T, HD); k_tail, v_tail: (S, KV, HD); pools: (n_pages, page, KV,
// HD); scales (n_pages, page, KV) fp32 when pool_int8 (else ignored);
// page_ids: (npp,) int32; out: (H, T, HD) fp32. q and the tail are bf16
// (is_bf16 = 1) or fp32; the pools are int8 (pool_int8 = 1) or the tail's
// dtype. HD in {16, 64, 128, 256}; H = KV * n_rep. Returns
// cudaGetLastError().
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

// The tensor-core route: q (H, T, HD), k_tail, v_tail (S, KV, HD) bf16;
// pools (n_pages, page, KV, HD) bf16, or int8 with fp32 scales (n_pages,
// page, KV) when pool_int8; page a power of two >= 8; the key window split
// into nsplit shares, each written to part_o (nsplit, H * T, HD) and
// part_ml (nsplit, H * T, 2) fp32 and merged by a second kernel (unused
// when nsplit = 1); other arguments as above. All contiguous and 16-byte
// aligned. Returns cudaGetLastError() after the launches, or the error that
// kept them from running.
int paged_prefix_attention_tc(const void* q, const void* k_tail, const void* v_tail,
                              const void* k_pool, const void* v_pool,
                              const float* k_scale, const float* v_scale,
                              const int32_t* page_ids, float* out, float* part_o,
                              float* part_ml, int pool_int8, int n_pages, int nsplit,
                              int H, int T, int S, int KV, int HD, int n_rep, int page,
                              int npp, int offset, int prefix_len, int length, int window,
                              float softcap, float scale, void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (T < 1 || S < 1 || KV < 1 || KV > 65535 || n_rep < 1 || H != KV * n_rep
        || page < 8 || (page & (page - 1)) != 0 || n_pages < 1 || nsplit < 1
        || nsplit > 65535 || (nsplit > 1 && (part_o == nullptr || part_ml == nullptr))
        || (long long)n_pages * page >= (1LL << 31) || (long long)H * T >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const TcArgs a{static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool),
                   k_scale, v_scale, page_ids, out, part_o, part_ml, nsplit, T, S, KV,
                   n_rep, page, npp, offset, prefix_len, length, window, softcap, scale};
    return (int)(pool_int8
        ? launch_tc_hd<true>(HD, q, k_tail, v_tail, k_pool, v_pool, n_pages, a, s)
        : launch_tc_hd<false>(HD, q, k_tail, v_tail, k_pool, v_pool, n_pages, a, s));
}

// The tensor-core route's tiles (attn::export_tiles; out holds 11 ints).
int paged_prefix_attention_tc_tiles(int* out)
{
    return attn::export_tiles(out);
}

const char* paged_prefix_attention_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
