// Paged flash-decode for Hopper (sm_90a): one new token per lane attends over
// the lane's block-table pages of a shared K/V pool, read in place.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_flash_decode (body _decode_kernel). Same contract: q (L, KV, R, hd)
// grouped queries, pools (n_pages, page, KV, hd), block_table (L, C) int32,
// pos (L,) int32 with the new token already written at pos; only the
// min(C, (pos + page) // page) live pages of a lane are read; row kpos is
// valid iff kpos <= pos and, with a window, kpos > pos - window; scores are
// q.k * scale, then the tanh softcap, then the mask (-1e30); the output is
// acc / max(l, 1e-30) in fp32.
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
//  * pools are bf16 or fp32 here; int8 pools with per-row scales come with
//    the kv-quant slice and are refused by the wrapper.
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

template <typename T, int HD, int R>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_split(const T* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, const int32_t* __restrict__ bt,
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
        const size_t base = (((size_t)pid * page + row) * KV + g) * HD + t * EPL;
        float kr[EPL], vr[EPL];
        load_row(kpool + base, kr);
        load_row(vpool + base, vr);

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

template <typename T, int HD, int R>
void launch(const void* q, const void* k, const void* v, const int32_t* bt,
            const int32_t* pos, float* pm, float* pl, float* pa, int L, int KV,
            int page, int C, int nsplit, int pps, int window, float softcap,
            float scale, cudaStream_t s)
{
    paged_decode_split<T, HD, R><<<dim3(L, KV, nsplit), WARPS * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        bt, pos, pm, pl, pa, KV, page, C, pps, window, softcap, scale);
}

template <typename T, int HD>
bool launch_r(int R, const void* q, const void* k, const void* v, const int32_t* bt,
              const int32_t* pos, float* pm, float* pl, float* pa, int L, int KV,
              int page, int C, int nsplit, int pps, int window, float softcap,
              float scale, cudaStream_t s)
{
#define REPRO_R(RR)                                                                   \
    case RR:                                                                          \
        launch<T, HD, RR>(q, k, v, bt, pos, pm, pl, pa, L, KV, page, C, nsplit, pps,  \
                          window, softcap, scale, s);                                 \
        return true;
    switch (R) {
        REPRO_R(1) REPRO_R(2) REPRO_R(4) REPRO_R(8)
        default: return false;
    }
#undef REPRO_R
}

template <typename T>
bool launch_hd(int HD, int R, const void* q, const void* k, const void* v,
               const int32_t* bt, const int32_t* pos, float* pm, float* pl, float* pa,
               int L, int KV, int page, int C, int nsplit, int pps, int window,
               float softcap, float scale, cudaStream_t s)
{
    switch (HD) {
        case 64: return launch_r<T, 64>(R, q, k, v, bt, pos, pm, pl, pa, L, KV, page, C,
                                        nsplit, pps, window, softcap, scale, s);
        case 128: return launch_r<T, 128>(R, q, k, v, bt, pos, pm, pl, pa, L, KV, page, C,
                                          nsplit, pps, window, softcap, scale, s);
        case 256: return launch_r<T, 256>(R, q, k, v, bt, pos, pm, pl, pa, L, KV, page, C,
                                          nsplit, pps, window, softcap, scale, s);
        default: return false;
    }
}

}  // namespace

extern "C" {

// q: (L, KV, R, HD); k/v pools: (n_pages, page, KV, HD), bf16 (is_bf16 = 1)
// or fp32, like q; bt: (L, C); pos: (L,); out: (L, KV, R, HD) fp32. Scratch:
// part_m/part_l (L, KV, nsplit, R), part_acc (L, KV, nsplit, R, HD) fp32.
// pps pages per split, nsplit * pps >= C. HD in {64, 128, 256}, R in
// {1, 2, 4, 8}. Returns cudaGetLastError() after the launches.
int paged_flash_decode(const void* q, const void* kpool, const void* vpool, int is_bf16,
                       const int32_t* bt, const int32_t* pos, float* out, float* part_m,
                       float* part_l, float* part_acc, int L, int KV, int R, int HD,
                       int page, int C, int nsplit, int pps, int window, float softcap,
                       float scale, void* stream)
{
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const bool ok = is_bf16
        ? launch_hd<__nv_bfloat16>(HD, R, q, kpool, vpool, bt, pos, part_m, part_l, part_acc,
                                   L, KV, page, C, nsplit, pps, window, softcap, scale, s)
        : launch_hd<float>(HD, R, q, kpool, vpool, bt, pos, part_m, part_l, part_acc,
                           L, KV, page, C, nsplit, pps, window, softcap, scale, s);
    if (!ok) return (int)cudaErrorInvalidValue;
    paged_decode_combine<<<L * KV, 256, 0, s>>>(part_m, part_l, part_acc, out, nsplit, R, HD);
    return (int)cudaGetLastError();
}

const char* paged_flash_decode_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
