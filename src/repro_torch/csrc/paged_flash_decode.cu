// Paged flash-decode for Hopper (sm_90a): one new token per lane attends over
// the lane's block-table pages of a shared K/V pool, read in place.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_flash_decode (body _decode_kernel). Same contract: q (L, KV, R, hd)
// grouped queries, pools (n_pages, page, KV, hd) in q's dtype or int8 with
// fp32 (n_pages, page, KV) per-row scales, block_table (L, C) int32,
// pos (L,) int32 with the new token already written at pos; only the
// min(C, (pos + page) // page) live pages of a lane are read; row kpos is
// valid iff kpos <= pos and, with a window, kpos > pos - window; scores are
// q.k * scale, then the tanh softcap, then the mask (-1e30); the output is
// acc / max(l, 1e-30) in fp32. An int8 row is dequantised on chip exactly
// as the TPU kernel's _dequant does: fp32(int8) * its row's scale, kept in
// fp32 (no cast to the model's dtype).
//
// What bounds it on the H100: the live K/V rows of every lane, read once
// from device memory (4 KB per token per layer at gemma2-2b widths). The
// arithmetic is ~4 flops per byte, far below the card's ridge: the limit is
// bytes in flight and the balance of the lanes' work over the SMs.
//
// Two routes (kernels/paged_attention.py::decode_route picks one):
//
// The tensor-core route (decode_tc, bf16 q over bf16 or int8 pools whose
// page is a power of two of at least 8 rows):
//  * shares of the live window, computed on the device: grid (L, KV,
//    nsplit), nsplit fixed by the host from the SM count alone. A block
//    finds its lane's page range [first, n_live) from pos (first = the
//    window's first page under a window, 0 without one or when no row is
//    valid), splits it evenly and takes share z (share(), mirrored line for
//    line by decode_shares in Python). Pages wholly outside the window are
//    never read, and a lane's pages spread over nsplit blocks whatever its
//    length;
//  * pages in flight by TMA: one producer warp reads the lane's block table
//    (prefetched to L2 while pos loads; 32 entries a load, handed out by
//    shuffles) and keeps a ring of STAGES shared-memory stages full, each 16
//    key rows of K and V of one KV head (a page of 16, half a page of 32,
//    two pages of 8), read in place as one (16 rows, 1, hd) box of a (rows,
//    KV, hd) map for K and one for V: whole rows, unswizzled (a swizzled box
//    is at most 128 bytes wide, four boxes a row at hd 256); 96 KB a block
//    in flight (6 stages at hd 256 bf16, 12 at int8), two blocks an SM;
//    int8 pages arrive as int8 boxes, their rows' scales by one bulk copy
//    each;
//  * scores on the tensor cores: each of NW = 6 consumer warps takes every
//    NW-th stage and runs mma.sync m16n8k16 (bf16, fp32 sums) with the 16
//    key rows as M and the R query heads (1, 2, 4, 6 or 8), padded to n =
//    8 (heads R..7 of the tile zero), as the B
//    fragment held in registers for the whole block. The contraction runs
//    over hd in a permuted order (kcol below), the same for A and B, so a
//    thread reads its A fragment as whole 16-byte chunks of the stage (rows
//    of one load phase share banks: two wavefronts a load); int8
//    codes are exact in bf16 (converted by a byte permute and an add, not
//    the quarter-rate conversion instruction), so an int8 row's dot is
//    q.codes on the tensor cores times the row's k scale;
//  * softcap and exponentials on the multi-function unit (ex2, rcp), with
//    the error csrc/attention_tc.cuh states (capped logit within c 2^-21);
//  * P.V stays fp32 on the CUDA cores, as the reference keeps p in fp32
//    (a bf16 P.V would move outputs by ~2^-9 relative): the warp's p go
//    through shared memory, each thread owns hd/32 columns of the R heads
//    and reads V rows from the stage four at a time, loads ahead of the
//    products (int8: fp32(code) * v scale);
//  * one launch, deterministic merge: a block's warps merge in warp order
//    in shared memory and write the share's (m, l, acc); the last block of
//    a (lane, KV head) to finish, found by an integer ticket that it resets,
//    merges the shares in split order (no float atomics), so a launch's
//    output repeats bit for bit; blocks of empty shares leave at once.
//
// The CUDA-core route (paged_decode_split + paged_decode_combine; fp32, or
// pages TMA cannot box):
//  * no staging of a lane's whole window. The TPU kernel copies C*page rows
//    into VMEM; one KV head of a 4096-row window is 2 MB at gemma2-2b
//    widths, against 227 KB of shared memory. Rows stream through an online
//    softmax instead: each warp takes one row at a time (a lane of the warp
//    holds hd/32 contiguous elements, so a row is one coalesced read; at
//    hd 16, the smoke configs', lanes 0-15 one each and the rest none) and
//    keeps m, l and acc for the R query heads of its KV head in registers;
//  * flash-decoding split: grid (L, KV, nsplit), each block a contiguous run
//    of the lane's pages, so 8 lanes x 4 KV heads still fill 132 SMs. The
//    four warps of a block merge in shared memory; a second small kernel
//    merges the splits in split order (deterministic, no atomics);
//  * every live page is read, including pages wholly outside the sliding
//    window: their rows are masked;
//  * pools are bf16 or fp32 like q, or int8: a lane then reads hd/32 int8
//    codes of the row (one 8-byte load at hd 256) and the row's fp32 scale
//    (one broadcast load), a quarter of a bf16 row's bytes.
//
// On both routes the reduction order differs from the reference's
// single-chunk softmax, so a kernel result agrees with the plain version to
// a tolerance, not bit for bit; and a lane whose every row is masked (far
// past its table under a window) averages all its live rows, as the
// reference does: m stays -1e30, every row weighs exp(0) = 1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int WARPS = 4;
constexpr float NEG = -1e30f;

template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&o)[N])
{
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
            o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = __ldg(p + i);
    }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float (&o)[N])
{
    if constexpr (N % 8 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 8) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + i));
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(h[j]);
                o[i + 2 * j] = f.x;
                o[i + 2 * j + 1] = f.y;
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
    }
}

template <int N>
__device__ __forceinline__ void load_row(const int8_t* __restrict__ p, float (&o)[N])
{
    if constexpr (N % 8 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 8) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + i));
            const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
            for (int j = 0; j < 8; ++j) o[i + j] = (float)b[j];
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = (float)p[i];
    }
}

// q in T; pools in KT (T, or int8 with per-(row, KV head) fp32 scales).
template <typename T, typename KT, int HD, int R>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_split(const T* __restrict__ q, const KT* __restrict__ kpool,
                   const KT* __restrict__ vpool, const float* __restrict__ kscale,
                   const float* __restrict__ vscale, const int32_t* __restrict__ bt,
                   const int32_t* __restrict__ pos, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int KV, int page, int C, int pps, int window, float softcap,
                   float scale)
{
    constexpr int EPL = (HD + 31) / 32;   // row elements per thread
    const int ln = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
    const int nsplit = gridDim.z;
    const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
    const bool holds = HD >= 32 || t < HD;        // at hd 16 lanes 16-31: none

    const int p = pos[ln];
    const int n_live = min(C, (p + page) / page);
    const int c0 = split * pps;
    const int c1 = min(n_live, c0 + pps);
    const int nrows = max(0, c1 - c0) * page;

    float qv[R][EPL] = {};
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (holds) load_row(q + ((size_t)(ln * KV + g) * R + r) * HD + t * EPL, qv[r]);

    float m[R], l[R], acc[R][EPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        m[r] = NEG;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }

    for (int i = warp; i < nrows; i += WARPS) {
        const int c = c0 + i / page;
        const int row = i - (c - c0) * page;
        const int pid = bt[(size_t)ln * C + c];
        const size_t cell = ((size_t)pid * page + row) * KV + g;
        const size_t base = cell * HD + t * EPL;
        float kr[EPL] = {}, vr[EPL] = {};
        if (holds) {
            load_row(kpool + base, kr);
            load_row(vpool + base, vr);
        }
        if constexpr (sizeof(KT) == 1) {   // _dequant: fp32(int8) * scale
            const float ks = __ldg(kscale + cell), vs = __ldg(vscale + cell);
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
                kr[e] *= ks;
                vr[e] *= vs;
            }
        }

        const int kpos = c * page + row;
        const bool valid = kpos <= p && (window <= 0 || kpos > p - window);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) d = fmaf(qv[r][e], kr[e], d);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
            float s = d * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            s = valid ? s : NEG;
            const float m_new = fmaxf(m[r], s);
            const float pe = expf(s - m_new);
            const float corr = expf(m[r] - m_new);
            l[r] = l[r] * corr + pe;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(acc[r][e], corr, pe * vr[e]);
            m[r] = m_new;
        }
    }

    __shared__ float sm_m[WARPS][R], sm_l[WARPS][R];
    __shared__ float sm_acc[WARPS][R][HD];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (t == 0) {
            sm_m[warp][r] = m[r];
            sm_l[warp][r] = l[r];
        }
        if (holds) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) sm_acc[warp][r][t * EPL + e] = acc[r][e];
        }
    }
    __syncthreads();

    const size_t slot = (size_t)(ln * KV + g) * nsplit + split;   // (L, KV, nsplit)
    for (int idx = threadIdx.x; idx < R * HD; idx += WARPS * 32) {
        const int r = idx / HD, d = idx - r * HD;
        float mx = NEG;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][r]);
        float ls = 0.f, as = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float corr = expf(sm_m[w][r] - mx);
            ls += sm_l[w][r] * corr;
            as += sm_acc[w][r][d] * corr;
        }
        part_acc[(slot * R + r) * HD + d] = as;
        if (d == 0) {
            part_m[slot * R + r] = mx;
            part_l[slot * R + r] = ls;
        }
    }
}

// Merge the splits of each (lane, KV head) in split order and normalise.
__global__ void paged_decode_combine(const float* __restrict__ part_m,
                                     const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc,
                                     float* __restrict__ out, int nsplit, int R, int HD)
{
    const size_t lg = blockIdx.x;                 // lane * KV + g
    for (int idx = threadIdx.x; idx < R * HD; idx += blockDim.x) {
        const int r = idx / HD, d = idx - r * HD;
        float mx = NEG;
        for (int s = 0; s < nsplit; ++s)
            mx = fmaxf(mx, part_m[(lg * nsplit + s) * R + r]);
        float ls = 0.f, as = 0.f;
        for (int s = 0; s < nsplit; ++s) {
            const size_t o = (lg * nsplit + s) * R + r;
            const float corr = expf(part_m[o] - mx);
            ls += part_l[o] * corr;
            as += part_acc[o * HD + d] * corr;
        }
        out[(lg * R + r) * HD + d] = as / fmaxf(ls, 1e-30f);
    }
}

struct Args {
    const void *q, *k, *v;
    const float *ks, *vs;
    const int32_t *bt, *pos;
    float *pm, *pl, *pa;
    int L, KV, page, C, nsplit, pps, window;
    float softcap, scale;
};

template <typename T, typename KT, int HD, int R>
void launch(const Args& a, cudaStream_t s)
{
    paged_decode_split<T, KT, HD, R><<<dim3(a.L, a.KV, a.nsplit), WARPS * 32, 0, s>>>(
        static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
        static_cast<const KT*>(a.v), a.ks, a.vs, a.bt, a.pos, a.pm, a.pl, a.pa, a.KV,
        a.page, a.C, a.pps, a.window, a.softcap, a.scale);
}

template <typename T, typename KT, int HD>
bool launch_r(int R, const Args& a, cudaStream_t s)
{
    switch (R) {
        case 1: launch<T, KT, HD, 1>(a, s); return true;
        case 2: launch<T, KT, HD, 2>(a, s); return true;
        case 4: launch<T, KT, HD, 4>(a, s); return true;
        case 6: launch<T, KT, HD, 6>(a, s); return true;
        case 8: launch<T, KT, HD, 8>(a, s); return true;
        default: return false;
    }
}

template <typename T, typename KT>
bool launch_hd(int HD, int R, const Args& a, cudaStream_t s)
{
    switch (HD) {
        case 16: return launch_r<T, KT, 16>(R, a, s);
        case 64: return launch_r<T, KT, 64>(R, a, s);
        case 128: return launch_r<T, KT, 128>(R, a, s);
        case 256: return launch_r<T, KT, 256>(R, a, s);
        default: return false;
    }
}

// ---------------------------------------------------------------------------
// The tensor-core route
// ---------------------------------------------------------------------------
namespace tc {

constexpr int NW = 6;                      // consumer warps
constexpr int THREADS = (NW + 1) * 32;     // + one producer warp
constexpr int TR = 16;                     // key rows a stage: the mma's M
constexpr int RING_BYTES = 98304;          // K and V bytes in flight, two blocks an SM
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// The layout of a stage's K (or V) tile: 16 rows of ROW_BYTES, one TMA box
// of whole rows, unswizzled (a 128-byte-swizzled box is at most 128 bytes
// wide: four boxes a row at hd 256).
template <int HD, bool QUANT>
struct Shape {
    static constexpr int ELEM = QUANT ? 1 : 2;
    static constexpr int ROW_BYTES = HD * ELEM;
    static constexpr int CPR = ROW_BYTES / 16;          // 16-byte chunks a row
    static constexpr int EPC = 16 / ELEM;               // elements a chunk
    static constexpr int TILE = TR * ROW_BYTES;
    // RING_BYTES of stages (6 pages of 16 rows at hd 256 bf16, 12 at int8),
    // a multiple of NW, at most 2 NW: consumer warp w takes tiles w, w +
    // NW, ..., so it alone reads stages w, w + NW, ..., each fill after the
    // last, and a barrier's parity never aliases (with another count a warp
    // could wait on a stage's third fill while its second is in flight, and
    // find the first's parity complete)
    static constexpr int FIT = RING_BYTES / (2 * TILE) / NW * NW;
    static constexpr int STAGES = FIT < NW ? NW : (FIT > 2 * NW ? 2 * NW : FIT);
    static constexpr int BPT = ROW_BYTES / 32;          // P.V bytes of a row a thread
    static constexpr int EPT = HD / 32;                 // P.V columns a thread
};

// One stage: the K tile, the V tile, and for int8 pools the 16 rows' k and
// v scales of every KV head (as the bulk copies bring them), rounded up to
// the 128-byte alignment of a TMA destination.
template <int HD, bool QUANT>
__host__ __device__ constexpr int stage_bytes(int KV)
{
    return (2 * Shape<HD, QUANT>::TILE + (QUANT ? 2 * TR * KV * 4 : 0) + 127) & ~127;
}

// Per warp: p of its stage's 16 rows x 8 heads and the heads' corrections.
constexpr int P_FLOATS = TR * 8 + 8;

// Dynamic shared memory: the ring (whose bytes the warps' merge reuses),
// the warps' p, the barriers, and 1 KB of alignment slack.
template <int HD, int R, bool QUANT>
__host__ __device__ constexpr int ring_region(int KV)
{
    const int ring = Shape<HD, QUANT>::STAGES * stage_bytes<HD, QUANT>(KV);
    const int merge = NW * (16 + R * HD) * 4;
    return ring > merge ? ring : merge;
}

template <int HD, int R, bool QUANT>
__host__ __device__ constexpr int smem_bytes(int KV)
{
    return 1024 + ring_region<HD, R, QUANT>(KV) + NW * P_FLOATS * 4
        + 2 * Shape<HD, QUANT>::STAGES * 8;
}

// Share z of nsplit of a lane's live window, in pages [c0, c1): the live
// pages are [0, n_live); the rows valid for the new token at p are [lo,
// hi]; the window starts at page first = lo / page, or 0 when no row is
// valid (the lane then averages every live row, as the reference does);
// [first, n_live) splits evenly. kernels/paged_attention.py::decode_shares
// is the same arithmetic, line for line.
__device__ __forceinline__ void share(int p, int page, int C, int window, int z,
                                      int nsplit, int& c0, int& c1)
{
    const int n_live = max(0, min(C, (p + page) / page));
    const int lo = window > 0 ? max(0, p - window + 1) : 0;
    const int hi = min(p, n_live * page - 1);
    const int first = lo <= hi ? lo / page : 0;
    const int n = n_live - first;
    c0 = first + z * n / nsplit;
    c1 = first + (z + 1) * n / nsplit;
}

// The element column of k-step i's values, for thread q = lane % 4 of the
// mma's fragments: a0 / b0 hold columns kcol, kcol + 1 and a2 / b1 columns
// kcol + 2, kcol + 3 (the mma's k indices 2q, 2q + 1 and 2q + 8, 2q + 9).
// Thread q owns chunks q, q + 4, q + 8, ... of a row, four columns a
// k-step; any order of the contraction gives the same sum up to its
// rounding, and this one lets a thread load its A values as whole chunks,
// the four threads of a row on distinct banks.
template <int HD, bool QUANT>
__device__ __forceinline__ int kcol(int q, int i)
{
    using S = Shape<HD, QUANT>;
    constexpr int W = S::EPC / 4;                       // k-steps a chunk
    return (4 * (i / W) + q) * S::EPC + 4 * (i % W);
}

__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float rcp(float x)
{
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// c * tanh(t) from one exp2 and one reciprocal (csrc/attention_tc.cuh)
__device__ __forceinline__ float capped(float t, float c)
{
    const float e = ex2(fabsf(t) * (-2.f * LOG2E));
    return copysignf(c * ((1.f - e) * rcp(1.f + e)), t);
}

// int8 code k of a word, given the word with each byte's sign bit flipped
// (w ^ 0x80808080: the code + 128), as fp32, exactly: 2^23 + (code + 128)
// by one byte permute, less 2^23 + 128 (a full-rate permute and add where a
// conversion instruction runs at a quarter of the rate)
__device__ __forceinline__ float code_f(uint32_t wx, int k)
{
    return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + k)) - 8388736.f;
}

// two int8 codes (bytes k, k + 1) as a bf16 pair, exact
__device__ __forceinline__ uint32_t codes_bf16(uint32_t wx, int k)
{
    const __nv_bfloat162 p = __floats2bfloat162_rn(code_f(wx, k), code_f(wx, k + 1));
    return *reinterpret_cast<const uint32_t*>(&p);
}

// BPT bytes of a V row in a thread's columns, as fp32
template <int HD, bool QUANT>
__device__ __forceinline__ void load_v(const uint8_t* tile, int j, int lane,
                                       float (&v)[Shape<HD, QUANT>::EPT])
{
    using S = Shape<HD, QUANT>;
    const uint8_t* src = tile + j * S::ROW_BYTES + lane * S::BPT;
    uint32_t w[(S::BPT + 3) / 4];
    if constexpr (S::BPT == 16) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else if constexpr (S::BPT == 8) {
        const uint2 u = *reinterpret_cast<const uint2*>(src);
        w[0] = u.x; w[1] = u.y;
    } else if constexpr (S::BPT == 4) {
        w[0] = *reinterpret_cast<const uint32_t*>(src);
    } else {
        w[0] = *reinterpret_cast<const uint16_t*>(src);
    }
#pragma unroll
    for (int e = 0; e < S::EPT; ++e) {
        if constexpr (QUANT)
            v[e] = code_f(w[e / 4] ^ 0x80808080u, e % 4);
        else
            v[e] = __uint_as_float((e % 2 ? w[e / 2] >> 16 : w[e / 2]) << 16);
    }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(hopper::smem_addr(dst)), "l"(src), "r"(bytes),
           "r"(hopper::smem_addr(bar)) : "memory");
}

struct Args {
    const __nv_bfloat16* q;
    const float *ks, *vs;
    const int32_t *bt, *pos;
    float *out, *part_ml, *part_acc;
    int* tickets;
    int KV, page, C, window, nsplit;
    float softcap, scale;
};

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[N])
{
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 4)
            *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else {
#pragma unroll
        for (int i = 0; i < N; i += 2)
            *reinterpret_cast<float2*>(dst + i) = make_float2(v[i], v[i + 1]);
    }
}

// The producer warp: lane j holds the physical page of the share's page
// base + j; lane 0 arms each stage and issues its loads.
template <int HD, bool QUANT>
__device__ __forceinline__ void produce(const CUtensorMap* tk, const CUtensorMap* tv,
                                        const Args& a, uint8_t* ring, int SB, uint64_t* full,
                                        uint64_t* empty, int ln, int kh, int c0, int c1,
                                        int lane)
{
    using S = Shape<HD, QUANT>;
    constexpr int STAGES = S::STAGES;
    const int32_t* btl = a.bt + (size_t)ln * a.C;
    const int rows = (c1 - c0) * a.page, ntiles = (rows + TR - 1) / TR;
    const int br = min(a.page, TR);                 // rows a box
    const uint32_t chunk = 2 * br * S::ROW_BYTES + (QUANT ? 2 * br * a.KV * 4 : 0);
    int base = c0;
    int pid_l = c0 + lane < c1 ? __ldg(btl + c0 + lane) : 0;
    for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
            hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * SB;
        const int nch = (min(TR, rows - it * TR) + br - 1) / br;
        for (int h = 0; h < nch; ++h) {
            const int rr = it * TR + h * br;
            const int c = c0 + rr / a.page, o = rr % a.page;
            if (c - base >= 32) {
                base += 32;
                pid_l = base + lane < c1 ? __ldg(btl + base + lane) : 0;
            }
            const int pid = __shfl_sync(FULL, pid_l, c - base);
            if (lane == 0) {
                if (h == 0)
                    hopper::mbar_arrive_expect_tx(&full[s], nch * chunk);
                const int row = pid * a.page + o;
                hopper::tma_load_3d(st + h * br * S::ROW_BYTES, tk, &full[s], 0, kh, row);
                hopper::tma_load_3d(st + S::TILE + h * br * S::ROW_BYTES, tv, &full[s], 0, kh,
                                    row);
                if constexpr (QUANT) {
                    float* scl = reinterpret_cast<float*>(st + 2 * S::TILE) + h * br * a.KV;
                    bulk_load(scl, a.ks + (size_t)row * a.KV, br * a.KV * 4, &full[s]);
                    bulk_load(scl + TR * a.KV, a.vs + (size_t)row * a.KV, br * a.KV * 4,
                              &full[s]);
                }
            }
        }
    }
}

// A consumer warp takes tiles warp, warp + NW, ... of the share; then the
// block's warps merge in warp order. With one share that is the output;
// with more, the share's (m, l) of each head go to part_ml (L, KV, nsplit,
// R, 2) and its unnormalised acc to part_acc (L, KV, nsplit, R, HD) (an
// empty share: m = -1e30, l = 0, zeros), and the last block of the lane
// merges them.
template <int HD, int R, bool QUANT>
__device__ __forceinline__ void consume(const Args& a, uint8_t* ring, int SB, float* pbuf,
                                        uint64_t* full, uint64_t* empty, int ln, int kh, int p,
                                        int c0, int c1, int warp, int lane)
{
    using S = Shape<HD, QUANT>;
    constexpr int STAGES = S::STAGES;
    const int rows = (c1 - c0) * a.page, ntiles = (rows + TR - 1) / TR;
    // thread (g, q) = (lane / 4, lane % 4) of the mma
    const int g = lane >> 2, q = lane & 3;
    uint32_t bq[HD / 16][2];                       // q of head g, every k-step
    {
        const __nv_bfloat16* qh = a.q + ((size_t)(ln * a.KV + kh) * R + min(g, R - 1)) * HD;
#pragma unroll
        for (int i = 0; i < HD / 16; ++i) {
            uint2 w = make_uint2(0u, 0u);
            if (g < R)
                w = __ldg(reinterpret_cast<const uint2*>(qh + kcol<HD, QUANT>(q, i)));
            bq[i][0] = w.x;
            bq[i][1] = w.y;
        }
    }
    const float sc = a.softcap > 0.f ? a.scale / a.softcap : a.scale;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};    // heads 2q, 2q + 1
    float acc[R][S::EPT];
#pragma unroll
    for (int n = 0; n < R; ++n)
#pragma unroll
        for (int e = 0; e < S::EPT; ++e) acc[n][e] = 0.f;
    float* pw = pbuf + warp * P_FLOATS;            // p[16][8], then corr[8]

    for (int it = warp; it < ntiles; it += NW) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* kt = ring + s * SB;
        const uint8_t* vt = kt + S::TILE;
        const float* ksc = reinterpret_cast<const float*>(kt + 2 * S::TILE);
        const float* vsc = ksc + TR * a.KV;

        // S = K q^T: rows g, g + 8 of the stage, heads 2q, 2q + 1; two
        // accumulators halve the chain of dependent mma
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int c = 0; c < S::CPR / 4; ++c) {
            const int off = (4 * c + q) * 16;
            const uint4 r0 = *reinterpret_cast<const uint4*>(kt + g * S::ROW_BYTES + off);
            const uint4 r1 = *reinterpret_cast<const uint4*>(kt + (g + 8) * S::ROW_BYTES + off);
            const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
            const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
            for (int w = 0; w < S::EPC / 4; ++w) {
                const int i = c * (S::EPC / 4) + w;
                if constexpr (QUANT) {
                    const uint32_t x0 = w0[w] ^ 0x80808080u, x1 = w1[w] ^ 0x80808080u;
                    mma16816(d[i & 1], codes_bf16(x0, 0), codes_bf16(x1, 0), codes_bf16(x0, 2),
                             codes_bf16(x1, 2), bq[i][0], bq[i][1]);
                } else {
                    mma16816(d[i & 1], w0[2 * w], w1[2 * w], w0[2 * w + 1], w1[2 * w + 1],
                             bq[i][0], bq[i][1]);
                }
            }
        }

        // scale, softcap, mask; the heads' running max over the stage
        const int nrows = min(TR, rows - it * TR);
        const int kpos0 = c0 * a.page + it * TR;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = g + 8 * (e >> 1), kpos = kpos0 + j;
            float v = (d[0][e] + d[1][e]) * sc;
            if constexpr (QUANT)
                v *= ksc[j * a.KV + kh];
            if (a.softcap > 0.f)
                v = capped(v, a.softcap);
            const bool ok = j < nrows && kpos <= p && (a.window <= 0 || kpos > p - a.window);
            x[e] = ok ? v : NEG;
        }
        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = fmaxf(x[h], x[h + 2]);
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
            mx = fmaxf(m[h], mx);
            // (m - m_new), never a difference of two products: -1e30 - -1e30
            // is exactly 0
            corr[h] = ex2((m[h] - mx) * LOG2E);
            m[h] = mx;
        }
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = g + 8 * (e >> 1);
            pe[e] = j < nrows ? ex2((x[e] - m[e & 1]) * LOG2E) : 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + pe[h] + pe[h + 2];
        *reinterpret_cast<float2*>(pw + g * 8 + 2 * q) = make_float2(pe[0], pe[1]);
        *reinterpret_cast<float2*>(pw + (g + 8) * 8 + 2 * q) = make_float2(pe[2], pe[3]);
        if (g == 0)
            *reinterpret_cast<float2*>(pw + TR * 8 + 2 * q) = make_float2(corr[0], corr[1]);
        __syncwarp();

        // acc = acc * corr + P V in fp32, hd / 32 columns a thread
#pragma unroll
        for (int n = 0; n < R; ++n) {
            const float cn = pw[TR * 8 + n];
#pragma unroll
            for (int e = 0; e < S::EPT; ++e) acc[n][e] *= cn;
        }
        // four rows at a time, their loads ahead of their products (a
        // stage's rows come in whole pages of at least 8)
#pragma unroll
        for (int j0 = 0; j0 < TR; j0 += 4) {
            if (j0 >= nrows)
                break;
            float v[4][S::EPT], pj[4][R];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                load_v<HD, QUANT>(vt, j0 + jj, lane, v[jj]);
#pragma unroll
                for (int n = 0; n < R; ++n) pj[jj][n] = pw[(j0 + jj) * 8 + n];
                if constexpr (QUANT) {
                    const float vs = vsc[(j0 + jj) * a.KV + kh];
#pragma unroll
                    for (int e = 0; e < S::EPT; ++e) v[jj][e] *= vs;
                }
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                for (int n = 0; n < R; ++n)
#pragma unroll
                    for (int e = 0; e < S::EPT; ++e)
                        acc[n][e] = fmaf(pj[jj][n], v[jj][e], acc[n][e]);
        }
        __syncwarp();
        if (lane == 0)
            hopper::mbar_arrive(&empty[s]);
    }

    // each head's sum over the warp's rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(FULL, l[h], 4);
        l[h] += __shfl_xor_sync(FULL, l[h], 8);
        l[h] += __shfl_xor_sync(FULL, l[h], 16);
    }
    // the warps merge in warp order, in the ring's bytes once every warp is
    // done with its stages; a float4 of outputs a thread (HD % 4 == 0)
    asm volatile("bar.sync 1, %0;\n" :: "n"(NW * 32) : "memory");
    float* ml = reinterpret_cast<float*>(ring);               // [NW][8][2]
    float* macc = ml + NW * 16;                               // [NW][R][HD]
    if (g == 0)
        *reinterpret_cast<float4*>(ml + warp * 16 + 4 * q) = make_float4(m[0], l[0], m[1], l[1]);
#pragma unroll
    for (int n = 0; n < R; ++n)
        store_row<S::EPT>(macc + (warp * R + n) * HD + lane * S::EPT, acc[n]);
    asm volatile("bar.sync 1, %0;\n" :: "n"(NW * 32) : "memory");

    const size_t lg = (size_t)ln * a.KV + kh;
    float* out = a.out + lg * R * HD;
    const size_t slot = lg * a.nsplit + blockIdx.z;
    for (int idx = 4 * threadIdx.x; idx < R * HD; idx += 4 * NW * 32) {
        const int r = idx / HD;
        float M = NEG, ls = 0.f, wt[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w)
            if (ml[w * 16 + 2 * r + 1] > 0.f)
                M = fmaxf(M, ml[w * 16 + 2 * r]);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float lw = ml[w * 16 + 2 * r + 1];
            wt[w] = lw > 0.f ? ex2((ml[w * 16 + 2 * r] - M) * LOG2E) : 0.f;
            ls += wt[w] * lw;
        }
        float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float4 v = *reinterpret_cast<const float4*>(macc + (w * R + r) * HD + idx % HD);
            as.x += wt[w] * v.x;
            as.y += wt[w] * v.y;
            as.z += wt[w] * v.z;
            as.w += wt[w] * v.w;
        }
        if (a.nsplit == 1) {                       // the share is the lane's window
            const float L = fmaxf(ls, 1e-30f);
            *reinterpret_cast<float4*>(out + idx) =
                make_float4(as.x / L, as.y / L, as.z / L, as.w / L);
        } else {
            *reinterpret_cast<float4*>(a.part_acc + slot * R * HD + idx) = as;
            if (idx % HD == 0)
                *reinterpret_cast<float2*>(a.part_ml + (slot * R + r) * 2) = make_float2(M, ls);
        }
    }
    if (a.nsplit == 1)
        return;

    // the last of the lane's nsplit blocks to finish (an integer ticket,
    // reset by that block for the next launch) merges the shares in split
    // order: out = sum_z w_z acc_z / max(sum_z w_z l_z, 1e-30), w_z = exp(m_z
    // - M), M the largest m_z of the shares that saw a row (l_z > 0). The
    // ticket's acq_rel atomic after the block's barrier releases the block's
    // partials (a release is cumulative) and acquires the others'.
    __shared__ int last;
    asm volatile("bar.sync 1, %0;\n" :: "n"(NW * 32) : "memory");
    if (threadIdx.x == 0) {
        int old;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                     : "=r"(old) : "l"(a.tickets + lg) : "memory");
        last = old == a.nsplit - 1;
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(NW * 32) : "memory");
    if (!last)
        return;
    const float* pml = a.part_ml + lg * a.nsplit * R * 2;
    const float* pacc = a.part_acc + lg * a.nsplit * R * HD;
    for (int idx = 4 * threadIdx.x; idx < R * HD; idx += 4 * NW * 32) {
        const int r = idx / HD;
        // the first eight shares' (m, l) and partials in flight together
        float2 v0[8];
        float4 u0[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (j < a.nsplit) {
                v0[j] = __ldcg(reinterpret_cast<const float2*>(pml + (j * R + r) * 2));
                u0[j] = __ldcg(reinterpret_cast<const float4*>(pacc + (size_t)j * R * HD + idx));
            }
        float M = NEG;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (j < a.nsplit && v0[j].y > 0.f)
                M = fmaxf(M, v0[j].x);
        for (int zz = 8; zz < a.nsplit; ++zz) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(pml + (zz * R + r) * 2));
            if (v.y > 0.f)
                M = fmaxf(M, v.x);
        }
        // an empty share's partial is zeros, weighed 0
        float ls = 0.f;
        float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
        const auto add = [&](float2 v, float4 u) {
            const float w = v.y > 0.f ? ex2((v.x - M) * LOG2E) : 0.f;
            ls += w * v.y;
            as.x += w * u.x;
            as.y += w * u.y;
            as.z += w * u.z;
            as.w += w * u.w;
        };
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (j < a.nsplit)
                add(v0[j], u0[j]);
        for (int zz = 8; zz < a.nsplit; ++zz)
            add(__ldcg(reinterpret_cast<const float2*>(pml + (zz * R + r) * 2)),
                __ldcg(reinterpret_cast<const float4*>(pacc + (size_t)zz * R * HD + idx)));
        const float L = fmaxf(ls, 1e-30f);
        *reinterpret_cast<float4*>(out + idx) = make_float4(as.x / L, as.y / L, as.z / L, as.w / L);
    }
    if (threadIdx.x == 0)
        a.tickets[lg] = 0;
}

// Block (lane ln, KV head kh, share z): a producer warp streams the share's
// pages through the ring, NW consumer warps attend over them (consume).
template <int HD, int R, bool QUANT>
__global__ void __launch_bounds__(THREADS, 2)
decode_tc(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
          const Args a)
{
    constexpr int STAGES = Shape<HD, QUANT>::STAGES;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = hopper::align_1024(smem_raw);
    const int SB = stage_bytes<HD, QUANT>(a.KV);
    float* pbuf = reinterpret_cast<float*>(ring + ring_region<HD, R, QUANT>(a.KV));
    uint64_t* full = reinterpret_cast<uint64_t*>(pbuf + NW * P_FLOATS);
    uint64_t* empty = full + STAGES;

    const int ln = blockIdx.x, kh = blockIdx.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == NW) {
        if (32 * lane < a.C)                       // the table row, to L2
            asm volatile("prefetch.global.L2 [%0];"
                         :: "l"(a.bt + (size_t)ln * a.C + 32 * lane));
        if (lane == 0) {
            asm volatile("prefetch.tensormap [%0];" :: "l"(&tk) : "memory");
            asm volatile("prefetch.tensormap [%0];" :: "l"(&tv) : "memory");
        }
    }
    const int p = __ldg(a.pos + ln);
    int c0, c1;
    share(p, a.page, a.C, a.window, blockIdx.z, a.nsplit, c0, c1);

    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 1);
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();
    if (warp == NW)
        produce<HD, QUANT>(&tk, &tv, a, ring, SB, full, empty, ln, kh, c0, c1, lane);
    else
        consume<HD, R, QUANT>(a, ring, SB, pbuf, full, empty, ln, kh, p, c0, c1, warp, lane);
}

// A 3-D map of a pool (rows, KV, HD) read in unswizzled (HD, 1, 16 or page
// rows) boxes: whole rows of one KV head. TMA needs a 16-byte-aligned base
// and row strides that are multiples of 16 bytes (HD * elem >= 64).
template <int HD, bool QUANT>
cudaError_t pool_map(CUtensorMap* map, const void* base, uint64_t rows, int KV, int box_rows)
{
    using S = Shape<HD, QUANT>;
    const hopper::EncodeTiled fn = hopper::encode_tiled();
    if (fn == nullptr)
        return cudaErrorNotSupported;
    if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
        return cudaErrorInvalidValue;
    const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)KV, rows};
    const cuuint64_t strides[2] = {(cuuint64_t)S::ROW_BYTES, (cuuint64_t)S::ROW_BYTES * KV};
    const cuuint32_t box[3] = {(cuuint32_t)HD, 1, (cuuint32_t)box_rows};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = fn(map, QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          3, const_cast<void*>(base), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, int R, bool QUANT>
cudaError_t launch(const void* kp, const void* vp, int n_pages, int L, const Args& a,
                   cudaStream_t s)
{
    const auto kernel = decode_tc<HD, R, QUANT>;
    const int smem = smem_bytes<HD, R, QUANT>(a.KV);
    CUtensorMap tk, tv;
    const int br = min(a.page, TR);
    cudaError_t e = pool_map<HD, QUANT>(&tk, kp, (uint64_t)n_pages * a.page, a.KV, br);
    if (e == cudaSuccess)
        e = pool_map<HD, QUANT>(&tv, vp, (uint64_t)n_pages * a.page, a.KV, br);
    if (e == cudaSuccess && smem > 232448 - 1024)
        e = cudaErrorInvalidValue;
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess)
        return e;
    kernel<<<dim3(L, a.KV, a.nsplit), THREADS, smem, s>>>(tk, tv, a);
    return cudaGetLastError();
}

template <int HD, bool QUANT>
cudaError_t launch_r(int R, const void* kp, const void* vp, int n_pages, int L, const Args& a,
                     cudaStream_t s)
{
    switch (R) {
        case 1: return launch<HD, 1, QUANT>(kp, vp, n_pages, L, a, s);
        case 2: return launch<HD, 2, QUANT>(kp, vp, n_pages, L, a, s);
        case 4: return launch<HD, 4, QUANT>(kp, vp, n_pages, L, a, s);
        case 6: return launch<HD, 6, QUANT>(kp, vp, n_pages, L, a, s);
        case 8: return launch<HD, 8, QUANT>(kp, vp, n_pages, L, a, s);
        default: return cudaErrorInvalidValue;
    }
}

template <bool QUANT>
cudaError_t launch_hd(int HD, int R, const void* kp, const void* vp, int n_pages, int L,
                      const Args& a, cudaStream_t s)
{
    switch (HD) {
        case 64: return launch_r<64, QUANT>(R, kp, vp, n_pages, L, a, s);
        case 128: return launch_r<128, QUANT>(R, kp, vp, n_pages, L, a, s);
        case 256: return launch_r<256, QUANT>(R, kp, vp, n_pages, L, a, s);
        default: return cudaErrorInvalidValue;
    }
}

// stages and dynamic shared bytes of instance <HD, R, QUANT> at KV heads
template <int HD, bool QUANT>
int plan_r(int R, int KV, int* out)
{
    out[0] = Shape<HD, QUANT>::STAGES;
    out[2] = THREADS;
    switch (R) {
        case 1: out[1] = smem_bytes<HD, 1, QUANT>(KV); return 0;
        case 2: out[1] = smem_bytes<HD, 2, QUANT>(KV); return 0;
        case 4: out[1] = smem_bytes<HD, 4, QUANT>(KV); return 0;
        case 6: out[1] = smem_bytes<HD, 6, QUANT>(KV); return 0;
        case 8: out[1] = smem_bytes<HD, 8, QUANT>(KV); return 0;
        default: return (int)cudaErrorInvalidValue;
    }
}

template <bool QUANT>
int plan_hd(int HD, int R, int KV, int* out)
{
    switch (HD) {
        case 64: return plan_r<64, QUANT>(R, KV, out);
        case 128: return plan_r<128, QUANT>(R, KV, out);
        case 256: return plan_r<256, QUANT>(R, KV, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace tc

}  // namespace

extern "C" {

// q: (L, KV, R, HD), bf16 (is_bf16 = 1) or fp32; k/v pools: (n_pages, page,
// KV, HD) in q's dtype, or int8 (pool_int8 = 1) with fp32 (n_pages, page,
// KV) scales kscale/vscale (ignored otherwise); bt: (L, C); pos: (L,); out:
// (L, KV, R, HD) fp32. Scratch: part_m/part_l (L, KV, nsplit, R), part_acc
// (L, KV, nsplit, R, HD) fp32. pps pages per split, nsplit * pps >= C. HD
// in {16, 64, 128, 256}, R in {1, 2, 4, 6, 8}. Returns cudaGetLastError()
// after the launches.
int paged_flash_decode(const void* q, const void* kpool, const void* vpool,
                       const float* kscale, const float* vscale, int is_bf16,
                       int pool_int8, const int32_t* bt, const int32_t* pos, float* out,
                       float* part_m, float* part_l, float* part_acc, int L, int KV, int R,
                       int HD, int page, int C, int nsplit, int pps, int window,
                       float softcap, float scale, void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const Args a{q, kpool, vpool, kscale, vscale, bt, pos, part_m, part_l, part_acc,
                 L, KV, page, C, nsplit, pps, window, softcap, scale};
    bool ok;
    if (is_bf16)
        ok = pool_int8 ? launch_hd<__nv_bfloat16, int8_t>(HD, R, a, s)
                       : launch_hd<__nv_bfloat16, __nv_bfloat16>(HD, R, a, s);
    else
        ok = pool_int8 ? launch_hd<float, int8_t>(HD, R, a, s)
                       : launch_hd<float, float>(HD, R, a, s);
    if (!ok) return (int)cudaErrorInvalidValue;
    paged_decode_combine<<<L * KV, 256, 0, s>>>(part_m, part_l, part_acc, out, nsplit, R, HD);
    return (int)cudaGetLastError();
}

// The tensor-core route: q (L, KV, R, HD) bf16; pools (n_pages, page, KV,
// HD) bf16, or int8 (pool_int8 = 1) with fp32 (n_pages, page, KV) scales;
// page a power of two >= 8; bt (L, C), pos (L,) int32; out (L, KV, R, HD)
// fp32; nsplit shares a lane, with scratch part_ml (L, KV, nsplit, R, 2)
// and part_acc (L, KV, nsplit, R, HD) fp32 and L * KV int32 tickets that
// are 0 on entry and left 0 (unused when nsplit = 1); nsplit <= 512. HD
// in {64, 128,
// 256}, R in {1, 2, 4, 6, 8}; all contiguous and 16-byte aligned. Returns
// cudaGetLastError() after the launch, or the error that kept it from
// running.
int paged_flash_decode_tc(const void* q, const void* kpool, const void* vpool,
                          const float* kscale, const float* vscale, const int32_t* bt,
                          const int32_t* pos, float* out, float* part_ml, float* part_acc,
                          int* tickets, int pool_int8, int n_pages, int L, int KV, int R, int HD,
                          int page, int C, int nsplit, int window, float softcap, float scale,
                          void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (L < 1 || KV < 1 || KV > 65535 || C < 1 || n_pages < 1 || page < 8
        || (page & (page - 1)) != 0 || nsplit < 1 || nsplit > 512
        || (nsplit > 1 && (part_ml == nullptr || part_acc == nullptr || tickets == nullptr))
        || (long long)n_pages * page >= (1LL << 31)
        || (pool_int8 && (kscale == nullptr || vscale == nullptr)))
        return (int)cudaErrorInvalidValue;
    const tc::Args a{static_cast<const __nv_bfloat16*>(q), kscale, vscale, bt, pos, out,
                     part_ml, part_acc, tickets, KV, page, C, window, nsplit, softcap, scale};
    return (int)(pool_int8 ? tc::launch_hd<true>(HD, R, kpool, vpool, n_pages, L, a, s)
                           : tc::launch_hd<false>(HD, R, kpool, vpool, n_pages, L, a, s));
}

// The tensor-core route's plan for head dim HD, group size R, an int8
// (pool_int8 = 1) or bf16 pool and KV heads: out[0] ring stages, out[1]
// dynamic shared bytes, out[2] threads a block. Returns 0, or an error code
// for a shape the route is not built for.
int paged_flash_decode_tc_plan(int HD, int R, int pool_int8, int KV, int* out)
{
    return pool_int8 ? tc::plan_hd<true>(HD, R, KV, out) : tc::plan_hd<false>(HD, R, KV, out);
}

const char* paged_flash_decode_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
