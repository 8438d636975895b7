// Boolean (+-1 int8) GEMM for Hopper (sm_90a), paper Eq 1 under the +-1
// embedding, with the threshold activation optionally fused:
//
//   s[i,j] = sum_k x[i,k] * w[k,j]            (int32 counts), or
//   y[i,j] = s[i,j] >= tau ? +1 : -1          (int8, s never reaches HBM)
//
// x: (M, K) int8 row-major; the weight comes transposed, wt = w^T: (N, K)
// int8 row-major; entries are +-1, or 0 where im2col pads or K was padded to
// a multiple of 16 (a 0 adds nothing).
//
// Replaces the TPU kernel src/repro/kernels/boolean_matmul.py::boolean_matmul
// (body _bool_matmul_kernel), whose grid walks K innermost and carries an
// int32 (bm, bn) sum in VMEM scratch from one grid step to the next.
//
// What bounds it on the H100. At the vision path's shapes (VGG-SMALL at
// batch 100: M = 6,400..25,600 pixels, K = 1,152..4,608, N = 256..512) it
// does 2*M*K*N integer operations on M*K + K*N bytes in and 4*M*N (counts)
// or M*N (threshold) bytes out. At the int8 tensor-core rate (1,979 TOPS
// dense) the operations take less time than moving x and the counts at
// 3.35 TB/s, so the bytes bound it (chip_smoke.py's bound: 0.066 ms for
// the four VGG GEMMs' counts, 0.053 ms with the threshold, against 0.046
// ms of operations): the kernel has to keep the tensor cores fed from a
// TMA ring and write its output in whole sectors.
//
// Design (the skeleton and its pipeline are hopper_gemm.cuh's ring_kernel):
//  * wgmma.m64nNk32.s32.s8.s8: int32 sums, exact. 8-bit wgmma reads both
//    operands K-major only, which x is; w (K, N) is not, so the wrapper
//    hands over wt = w^T (one copy of the weight a call, a few MB at most)
//    and pads K to a multiple of 16 for TMA's 16-byte row stride;
//  * a block owns a 128 x BN output tile, BN = 64, 128 or 256 (the
//    narrowest that covers N: 256 for VGG-SMALL, 64 for SMALL-EDSR), and
//    walks K in tiles of 128 bytes: TMA brings a 128 x 128 box of x and a
//    BN x 128 box of wt, 128-byte swizzled, into a ring of 4 stages (3 at
//    BN = 128); each consumer warpgroup issues 4 wgmma k-steps (32 bytes
//    each) a stage on its 64 rows. Narrow tiles run two blocks an SM, so one
//    block's epilogue overlaps the other's main loop;
//  * TMA zero-fills rows past M and N and k past K, so ragged shapes need no
//    other code; the epilogue masks its stores;
//  * the epilogue writes the int32 counts from the accumulator fragment,
//    each thread's pairs of neighbouring columns as one 8-byte store (four
//    threads fill a row's 32-byte sector); or compares each sum with tau
//    (exact: |s| <= K < 2^24) and writes int8 +-1, the four threads of a row
//    swapping bytes with shuffles so that each stores 8 whole columns and
//    the sectors are again written whole (2-byte or byte stores where
//    N % 8 != 0);
//  * the wrapper's transposed copy of w is this library's transpose kernel
//    (32 x 32 tiles through shared memory), K's zero padding included.
#include "hopper_gemm.cuh"

namespace {

constexpr int BK = 128;                  // k bytes a stage: one 128B-swizzle row

template <int BN_, int STAGES_, int BLOCKS_, bool FUSE>
struct boolean_matmul_tc {
    static constexpr int BN = BN_;
    static constexpr int STAGES = STAGES_;
    static constexpr int BLOCKS = BLOCKS_;
    static constexpr uint32_t A_BYTES = hopper::BM * BK;
    static constexpr uint32_t B_BYTES = BN * BK;
    static constexpr uint32_t A_WG = 64 * BK;
    struct Args {
        void* y;
        int M, N, K;
        float tau;
    };
    using Acc = int[BN / 2];

    __device__ static int k_tiles(const Args& a) { return (a.K + BK - 1) / BK; }

    __device__ static void load(uint8_t* a, uint8_t* b, const CUtensorMap* ta,
                                const CUtensorMap* tb, uint64_t* bar, int kt,
                                int m0, int n0)
    {
        hopper::tma_load_2d(a, ta, bar, kt * BK, m0);
        hopper::tma_load_2d(b, tb, bar, kt * BK, n0);
    }

    __device__ static void mma(Acc& d, uint32_t a, uint32_t b)
    {
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks)
            hopper::wgmma_s8(d, hopper::desc_sw128(a + 32 * ks, 16, 1024),
                             hopper::desc_sw128(b + 32 * ks, 16, 1024));
    }

    __device__ static void store(const Acc& d, const Args& args, int row0,
                                 int n0, int t)
    {
        const int r0 = row0 + 16 * (t / 32) + (t % 32) / 4;
        if (FUSE && args.N % 8 == 0) {
            store_rows8(d, args, r0, n0, t);
            return;
        }
        const bool pairs = (args.N % 2) == 0;      // 2-element stores aligned
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int n = n0 + 8 * j + 2 * (t % 4);
            if (n >= args.N)
                continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = r0 + 8 * h;
                if (m >= args.M)
                    continue;
                const int s0 = d[4 * j + 2 * h], s1 = d[4 * j + 2 * h + 1];
                const size_t o = (size_t)m * args.N + n;
                if (FUSE) {
                    int8_t* y = static_cast<int8_t*>(args.y);
                    const int8_t v0 = ((float)s0 >= args.tau) ? 1 : -1;
                    const int8_t v1 = ((float)s1 >= args.tau) ? 1 : -1;
                    if (pairs) {
                        *reinterpret_cast<char2*>(y + o) = make_char2(v0, v1);
                    } else {
                        y[o] = v0;
                        if (n + 1 < args.N) y[o + 1] = v1;
                    }
                } else {
                    int32_t* y = static_cast<int32_t*>(args.y);
                    if (pairs) {
                        *reinterpret_cast<int2*>(y + o) = make_int2(s0, s1);
                    } else {
                        y[o] = s0;
                        if (n + 1 < args.N) y[o + 1] = s1;
                    }
                }
            }
        }
    }

    // The threshold's int8 +-1 with N % 8 == 0: a thread holds 2 bytes of
    // each 8-column chunk of its row; the 4 threads of a row swap them so
    // that each holds 8 whole columns, and 4 threads write a 32-byte sector
    // (whole sectors, as the int32 counts are written).
    __device__ static void store_rows8(const Acc& d, const Args& args, int r0,
                                       int n0, int t)
    {
        const int q = t % 4, quad = (t % 32) & ~3;
#pragma unroll
        for (int jg = 0; jg < BN / 32; ++jg) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint32_t v[4];                     // chunk 4 jg + c, 2 bytes
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = 4 * jg + c;
                    v[c] = ((float)d[4 * j + 2 * h] >= args.tau ? 0x01u : 0xFFu)
                        | ((float)d[4 * j + 2 * h + 1] >= args.tau ? 0x0100u : 0xFF00u);
                }
                uint32_t lo = 0, hi = 0;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    // this round thread q reads thread p = q + r of its row,
                    // which sends the bytes of the chunk its reader gathers
                    const int p = (q + r) & 3, c = (q - r) & 3;
                    const uint32_t send = c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
                    const uint32_t got = __shfl_sync(0xffffffffu, send, quad | p);
                    if (p < 2) lo |= got << (16 * p);
                    else hi |= got << (16 * (p - 2));
                }
                const int m = r0 + 8 * h, n = n0 + 8 * (4 * jg + q);
                if (m < args.M && n < args.N)
                    *reinterpret_cast<uint2*>(static_cast<int8_t*>(args.y)
                                              + (size_t)m * args.N + n) = make_uint2(lo, hi);
            }
        }
    }
};

// wt[n, k] = w[k, n] for k < K, 0 for K <= k < Kp: the weight as 8-bit wgmma
// reads it (K-major), K padded for TMA. 32 x 32 tiles through shared memory,
// so both the reads of w and the writes of wt are row-contiguous.
__global__ void __launch_bounds__(256)
transpose_pad_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
                     int K, int N, int Kp)
{
    __shared__ int8_t tile[32][33];
    const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
#pragma unroll
    for (int r = threadIdx.y; r < 32; r += 8) {
        const int k = k0 + r, n = n0 + threadIdx.x;
        tile[r][threadIdx.x] = (k < K && n < N) ? w[(size_t)k * N + n] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int r = threadIdx.y; r < 32; r += 8) {
        const int n = n0 + r, k = k0 + threadIdx.x;
        if (n < N && k < Kp)
            wt[(size_t)n * Kp + k] = tile[threadIdx.x][r];
    }
}

template <int BN, int STAGES, int BLOCKS>
cudaError_t launch_cfg(const CUtensorMap& ta, const CUtensorMap& tb, void* y,
                       int M, int K, int N, int fuse, float tau, cudaStream_t s)
{
    if (fuse) {
        using P = boolean_matmul_tc<BN, STAGES, BLOCKS, true>;
        return hopper::launch<P>(ta, tb, typename P::Args{y, M, N, K, tau}, M, N, s);
    }
    using P = boolean_matmul_tc<BN, STAGES, BLOCKS, false>;
    return hopper::launch<P>(ta, tb, typename P::Args{y, M, N, K, tau}, M, N, s);
}

}  // namespace

extern "C" {

// x: (M, K) int8; wt: (N, K) int8, the weight transposed; y: (M, N) int32
// counts, or int8 +-1 (s >= tau) when fuse != 0. All row-major and
// contiguous; K a multiple of 16 and x, wt 16-byte aligned (TMA). Returns
// cudaGetLastError() after the launch, or the error that kept it from one.
int boolean_matmul(const int8_t* x, const int8_t* wt, void* y, int M, int K,
                   int N, int fuse, float tau, void* stream)
{
    if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0
        || (M + hopper::BM - 1) / hopper::BM > 65535)
        return (int)cudaErrorInvalidValue;
    // the narrowest tile that covers N; the two narrow ones run two blocks
    // an SM, so one block's epilogue overlaps the other's main loop
    const int bn = N <= 64 ? 64 : N <= 128 ? 128 : 256;
    CUtensorMap ta, tb;
    cudaError_t e = hopper::make_map(&ta, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                     M, K, hopper::BM);
    if (e == cudaSuccess)
        e = hopper::make_map(&tb, wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, bn);
    if (e != cudaSuccess)
        return (int)e;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (bn == 256)
        return (int)launch_cfg<256, 4, 1>(ta, tb, y, M, K, N, fuse, tau, s);
    if (bn == 128)
        return (int)launch_cfg<128, 3, 2>(ta, tb, y, M, K, N, fuse, tau, s);
    return (int)launch_cfg<64, 4, 2>(ta, tb, y, M, K, N, fuse, tau, s);
}

// wt (N, Kp) = w^T, zero past K: w (K, N) int8 row-major, Kp >= K. Returns
// cudaGetLastError() after the launch.
int boolean_matmul_transpose(const int8_t* w, int8_t* wt, int K, int N, int Kp,
                             void* stream)
{
    if (K <= 0 || N <= 0 || Kp < K || (N + 31) / 32 > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((Kp + 31) / 32, (N + 31) / 32);
    transpose_pad_kernel<<<grid, dim3(32, 8), 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(w, wt, K, N, Kp);
    return (int)cudaGetLastError();
}

const char* boolean_matmul_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
