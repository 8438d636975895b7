// Packed-XNOR GEMV for Hopper (sm_90a): y[M,N] = sum_k x[M,k] * e(w[k,N]).
//
// Replaces the TPU kernel src/repro/kernels/packed_xnor.py::packed_xnor_gemv
// (body _xnor_gemv_kernel). The Boolean weight is bit-packed along K: word
// (j, n) holds elements k = 32j .. 32j+31 of column n, bit b = element 32j+b,
// bit 1 = +1 (T), bit 0 = -1 (F). Activations are real (bf16 or fp32) and the
// sum is taken in fp32, as in the reference.
//
// What bounds it on the H100. At decode M (the lane count) the floor is the
// packed weight words plus x and y over 3.35 TB/s (~284 MB of words per
// gemma2-2b decode step, 32x less than bf16); at prefill M (<= 256 rows) it
// is the M*K*N products at the bf16 tensor-core rate. This first kernel does
// the additions on the CUDA cores (fp32 FMA with a +-1 factor) and reaches
// neither floor; the tensor-core form (unpack to bf16 +-1 fragments,
// mma/wgmma) and deeper load pipelining are later work.
//
// Design:
//  * a block owns BN = 256 output columns (2 per thread, read as one 8-byte
//    word pair so a warp reads 256 contiguous bytes of a packed row) and
//    BM = 8 activation rows; M above 8 tiles over grid.z;
//  * K is split over grid.y so that narrow N (2304 = 9 column tiles) still
//    fills 132 SMs. Each split writes its own fp32 partial (M, N) slab and a
//    second kernel sums the slabs in split order, so results repeat exactly
//    from run to run (no atomics);
//  * the block stages its x tile [BM, <=1024 k] in shared memory as fp32;
//    rows past M and k past k_valid are staged as 0, because a pad weight
//    bit is F = -1, not 0 (the reference zero-pads x the same way);
//  * words are read through uint32_t, so bit 31 of the int32 storage is an
//    ordinary bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 2;                 // output columns per thread
constexpr int BN = THREADS * COLS;      // output columns per block
constexpr int BM = 8;                   // activation rows per block
constexpr int KWS_MAX = 32;             // packed words per K split (32 KB of x)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
xnor_gemv_split(const T* __restrict__ x, const uint32_t* __restrict__ w,
                float* __restrict__ out, int M, int K, int Kw, int N, int kws)
{
    __shared__ __align__(16) float xs[BM][KWS_MAX * 32];

    const int n0 = blockIdx.x * BN + threadIdx.x * COLS;
    const int split = blockIdx.y;
    const int m0 = blockIdx.z * BM;
    const int kw0 = split * kws;
    const int nkw = min(kws, Kw - kw0);
    const int kn = nkw * 32;
    const int k0 = kw0 * 32;

    for (int i = threadIdx.x; i < BM * kn; i += THREADS) {
        const int r = i / kn, c = i - r * kn;
        const int m = m0 + r, k = k0 + c;
        xs[r][c] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    if (n0 >= N) return;

    float acc[BM][COLS];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

    const bool pair = (n0 + 1 < N);
    for (int j = 0; j < nkw; ++j) {
        const uint32_t* wp = w + (size_t)(kw0 + j) * N + n0;
        uint32_t wd[COLS];
        if (pair && ((reinterpret_cast<uintptr_t>(wp) & 7u) == 0)) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(wp));
            wd[0] = v.x;
            wd[1] = v.y;
        } else {
            wd[0] = __ldg(wp);
            wd[1] = pair ? __ldg(wp + 1) : 0u;
        }
#pragma unroll
        for (int b = 0; b < 32; b += 4) {
            float sgn[4][COLS];
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
                for (int c = 0; c < COLS; ++c)
                    sgn[t][c] = ((wd[c] >> (b + t)) & 1u) ? 1.f : -1.f;
#pragma unroll
            for (int r = 0; r < BM; ++r) {
                const float4 xv = *reinterpret_cast<const float4*>(&xs[r][j * 32 + b]);
                const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
                for (int t = 0; t < 4; ++t)
#pragma unroll
                    for (int c = 0; c < COLS; ++c)
                        acc[r][c] = fmaf(sgn[t][c], xa[t], acc[r][c]);
            }
        }
    }

    // out is y itself when there is one split, else split's partial slab
    float* o = out + (size_t)split * M * N;
#pragma unroll
    for (int r = 0; r < BM; ++r) {
        const int m = m0 + r;
        if (m >= M) break;
#pragma unroll
        for (int c = 0; c < COLS; ++c)
            if (n0 + c < N) o[(size_t)m * N + n0 + c] = acc[r][c];
    }
}

// Deterministic second pass: y = sum over splits, in split order.
__global__ void xnor_gemv_reduce(const float* __restrict__ part, float* __restrict__ y,
                                 long long mn, int ksplit)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= mn) return;
    float s = part[i];
    for (int k = 1; k < ksplit; ++k) s += part[(size_t)k * mn + i];
    y[i] = s;
}

}  // namespace

extern "C" {

// x: (M, K) bf16 (x_bf16 = 1) or fp32; w: (Kw, N) packed words; y: (M, N)
// fp32; part: (ksplit, M, N) fp32 scratch, used only when ksplit > 1.
// kws words per split, ksplit * kws >= Kw, kws <= 32. Returns
// cudaGetLastError() after the launches.
int xnor_gemv(const void* x, int x_bf16, const int32_t* w, float* y, float* part,
              int M, int K, int Kw, int N, int ksplit, int kws, void* stream)
{
    if (kws < 1 || kws > KWS_MAX || ksplit < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const dim3 grid((N + BN - 1) / BN, ksplit, (M + BM - 1) / BM);
    float* out = ksplit > 1 ? part : y;
    const uint32_t* wu = reinterpret_cast<const uint32_t*>(w);
    if (x_bf16)
        xnor_gemv_split<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), wu, out, M, K, Kw, N, kws);
    else
        xnor_gemv_split<float><<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(x), wu, out, M, K, Kw, N, kws);
    if (ksplit > 1) {
        const long long mn = (long long)M * N;
        const int t = 256;
        xnor_gemv_reduce<<<(unsigned)((mn + t - 1) / t), t, 0, s>>>(part, y, mn, ksplit);
    }
    return (int)cudaGetLastError();
}

const char* xnor_gemv_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
