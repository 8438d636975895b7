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
// arithmetic is ~2 flops per byte, far below the card's ridge.
//
// Design:
//  * no staging of a lane's whole window. The TPU kernel copies C*page rows
//    into VMEM; one KV head of a 4096-row window is 2 MB at gemma2-2b
//    widths, against 227 KB of shared memory. Rows stream through an online
//    softmax instead: each warp takes one row at a time (a lane of the warp
//    holds hd/32 contiguous elements, so a row is one coalesced read) and
//    keeps m, l and acc for the R query heads of its KV head in registers;
//  * flash-decoding split: grid (L, KV, nsplit), each block a contiguous run
//    of the lane's pages, so 8 lanes x 4 KV heads still fill 132 SMs. The
//    four warps of a block merge in shared memory; a second small kernel
//    merges the splits in split order (deterministic, no atomics);
//  * the reduction order differs from the reference's single-chunk softmax,
//    so a kernel result agrees with the plain version to a tolerance, not
//    bit for bit;
//  * every live page is read, including pages wholly outside the sliding
//    window: their rows are masked. Skipping them changes nothing for a
//    lane with a valid row and is left for a later change;
//  * a lane whose every row is masked (far past its table under a window)
//    averages all its live rows, as the reference does: m stays -1e30, every
//    row weighs exp(0) = 1;
//  * pools are bf16 or fp32 like q, or int8: a lane then reads hd/32 int8
//    codes of the row (one 8-byte load at hd 256) and the row's fp32 scale
//    (one broadcast load), a quarter of a bf16 row's bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
    constexpr int EPL = HD / 32;          // row elements per thread
    const int ln = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
    const int nsplit = gridDim.z;
    const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;

    const int p = pos[ln];
    const int n_live = min(C, (p + page) / page);
    const int c0 = split * pps;
    const int c1 = min(n_live, c0 + pps);
    const int nrows = max(0, c1 - c0) * page;

    float qv[R][EPL];
#pragma unroll
    for (int r = 0; r < R; ++r)
        load_row(q + ((size_t)(ln * KV + g) * R + r) * HD + t * EPL, qv[r]);

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
        float kr[EPL], vr[EPL];
        load_row(kpool + base, kr);
        load_row(vpool + base, vr);
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
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[warp][r][t * EPL + e] = acc[r][e];
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
        case 8: launch<T, KT, HD, 8>(a, s); return true;
        default: return false;
    }
}

template <typename T, typename KT>
bool launch_hd(int HD, int R, const Args& a, cudaStream_t s)
{
    switch (HD) {
        case 64: return launch_r<T, KT, 64>(R, a, s);
        case 128: return launch_r<T, KT, 128>(R, a, s);
        case 256: return launch_r<T, KT, 256>(R, a, s);
        default: return false;
    }
}

}  // namespace

extern "C" {

// q: (L, KV, R, HD), bf16 (is_bf16 = 1) or fp32; k/v pools: (n_pages, page,
// KV, HD) in q's dtype, or int8 (pool_int8 = 1) with fp32 (n_pages, page,
// KV) scales kscale/vscale (ignored otherwise); bt: (L, C); pos: (L,); out:
// (L, KV, R, HD) fp32. Scratch: part_m/part_l (L, KV, nsplit, R), part_acc
// (L, KV, nsplit, R, HD) fp32. pps pages per split, nsplit * pps >= C. HD
// in {64, 128, 256}, R in {1, 2, 4, 8}. Returns cudaGetLastError() after
// the launches.
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

const char* paged_flash_decode_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
