// Boolean (+-1 int8) GEMM for Hopper (sm_90a), paper Eq 1 under the +-1
// embedding, with the threshold activation optionally fused:
//
//   s[i,j] = sum_k x[i,k] * w[k,j]            (int32 counts), or
//   y[i,j] = s[i,j] >= tau ? +1 : -1          (int8, s never reaches HBM)
//
// x: (M, K) int8, w: (K, N) int8, both row-major; entries are +-1, or 0 where
// im2col pads (a 0 adds nothing).
//
// Replaces the TPU kernel src/repro/kernels/boolean_matmul.py::boolean_matmul
// (body _bool_matmul_kernel), whose grid walks K innermost and carries an
// int32 (bm, bn) sum in VMEM scratch from one grid step to the next.
//
// What bounds it on the H100. At the vision path's shapes (VGG-SMALL at
// batch 100: M = 6,400..25,600 pixels, K = 1,152..4,608, N = 256..512) it
// does 2*M*K*N integer operations on M*K + K*N bytes in and 4*M*N (counts)
// or M*N (threshold) bytes out: hundreds of operations per byte, so it is
// bound by operations, at the int8 tensor-core rate (1,979 TOPS dense).
// This first kernel uses the tensor cores through the warp-level
// mma.sync.m16n8k32 s8.s8.s32 (int32 sums, exact), not wgmma, and stages
// its tiles through registers, not TMA: those are later work.
//
// Design:
//  * a block of 256 threads (8 warps, 2 x 4) owns a 128 x 128 output tile
//    and walks all of K itself in tiles of 64, so every output is one
//    warp's sum over k = 0..K-1: no atomics, no second pass, and the result
//    repeats exactly from run to run. A warp owns 64 x 32 outputs: 4 x 4
//    mma tiles of 16 x 8, 64 int32 accumulators a thread;
//  * x tiles stay row-major in shared memory (rows of 64 bytes, padded to
//    80 so that the A-fragment reads hit 32 distinct banks); w tiles are
//    stored as words of 4 consecutive k of one column, [k/4][n], the B
//    fragment's own layout: each thread reads a 4 x 4 byte block of w (4
//    rows of 4 columns, coalesced along N), transposes it with byte_perm
//    and stores 4 such words at once;
//  * the next tile is read into registers while the current one is summed,
//    and shared memory is double-buffered, so one barrier a tile suffices;
//  * ragged K is zero-filled in shared memory and never read past K; rows
//    past M read as 0 and are not stored, nor are columns past N. 16-byte
//    and 4-byte loads need K % 16 == 0, N % 4 == 0 and aligned bases; other
//    shapes take byte loads (same tiles, same sums);
//  * the epilogue writes int32 counts, or compares each sum with tau
//    (exact: |s| <= K < 2^24) and writes int8 +-1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;                 // output rows per block
constexpr int BN = 128;                 // output columns per block
constexpr int BK = 64;                  // k per tile
constexpr int AS = BK + 16;             // bytes per x row in shared memory
constexpr int BS = BN + 8;              // words per k-quad row of w

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool VEC, bool FUSE>
__global__ void __launch_bounds__(THREADS)
boolean_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      void* __restrict__ y, int M, int K, int N, float tau)
{
    __shared__ __align__(16) uint8_t xs[2][BM][AS];
    __shared__ __align__(16) uint32_t ws[2][BK / 4][BS];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;          // mma group, thread in group
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    // staging map. x: 512 chunks of 16 bytes, chunk c = row c / 4, bytes
    // (c % 4) * 16. w: 512 blocks of 4 k x 4 n, block b = k-quad
    // (b / 8) % 16, column quad (b % 8) + 8 * (b / 128): 8 neighbouring
    // lanes read 32 contiguous bytes of one row of w
    uint4 xr[2];
    uint32_t wr[2][4];
    auto load = [&](int k0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int c = tid + THREADS * r;
            const int m = m0 + c / 4, k = k0 + (c % 4) * 16;
            if (VEC) {
                xr[r] = (m < M && k < K)
                    ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k))
                    : make_uint4(0u, 0u, 0u, 0u);
            } else {
                uint32_t v[4] = {0u, 0u, 0u, 0u};
                if (m < M) {
                    const int8_t* row = x + (size_t)m * K;
#pragma unroll
                    for (int e = 0; e < 16; ++e)
                        if (k + e < K)
                            v[e >> 2] |= (uint32_t)(uint8_t)row[k + e] << (8 * (e & 3));
                }
                xr[r] = make_uint4(v[0], v[1], v[2], v[3]);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int b = tid + THREADS * r;
            const int k = k0 + ((b >> 3) & 15) * 4;
            const int n = n0 + ((b & 7) + 8 * (b >> 7)) * 4;
            if (VEC) {
                uint32_t q[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    q[i] = (k < K && n < N)
                        ? __ldg(reinterpret_cast<const uint32_t*>(w + (size_t)(k + i) * N + n))
                        : 0u;
                // 4 x 4 byte transpose: word j = column n + j, bytes k..k+3
                const uint32_t t0 = __byte_perm(q[0], q[1], 0x5140);
                const uint32_t t1 = __byte_perm(q[0], q[1], 0x7362);
                const uint32_t t2 = __byte_perm(q[2], q[3], 0x5140);
                const uint32_t t3 = __byte_perm(q[2], q[3], 0x7362);
                wr[r][0] = __byte_perm(t0, t2, 0x5410);
                wr[r][1] = __byte_perm(t0, t2, 0x7632);
                wr[r][2] = __byte_perm(t1, t3, 0x5410);
                wr[r][3] = __byte_perm(t1, t3, 0x7632);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    uint32_t v = 0u;
                    if (n + j < N) {
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            if (k + i < K)
                                v |= (uint32_t)(uint8_t)w[(size_t)(k + i) * N + n + j] << (8 * i);
                    }
                    wr[r][j] = v;
                }
            }
        }
    };
    auto store = [&](int buf) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int c = tid + THREADS * r;
            *reinterpret_cast<uint4*>(&xs[buf][c / 4][(c % 4) * 16]) = xr[r];
            const int b = tid + THREADS * r;
            *reinterpret_cast<uint4*>(&ws[buf][(b >> 3) & 15][((b & 7) + 8 * (b >> 7)) * 4]) =
                make_uint4(wr[r][0], wr[r][1], wr[r][2], wr[r][3]);
        }
    };

    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    load(0);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
        const bool more = k0 + BK < K;
        if (more) load(k0 + BK);           // in flight while this tile is summed
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
            uint32_t a[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = wm + i * 16 + g;
                const int c = ks * 32 + t * 4;
                a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[buf][r][c]);
                a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[buf][r + 8][c]);
                a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[buf][r][c + 16]);
                a[i][3] = *reinterpret_cast<const uint32_t*>(&xs[buf][r + 8][c + 16]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = wn + j * 8 + g;
                const uint32_t b0 = ws[buf][ks * 8 + t][n];
                const uint32_t b1 = ws[buf][ks * 8 + 4 + t][n];
#pragma unroll
                for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], a[i], b0, b1);
            }
        }
        if (more) {
            store(buf ^ 1);                // the other buffer: nobody reads it now
            __syncthreads();
            buf ^= 1;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm + i * 16 + g + 8 * h;
            if (m >= M) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = n0 + wn + j * 8 + t * 2 + e;
                    if (n >= N) continue;
                    const int s = acc[i][j][2 * h + e];
                    if (FUSE)
                        static_cast<int8_t*>(y)[(size_t)m * N + n] =
                            ((float)s >= tau) ? (int8_t)1 : (int8_t)-1;
                    else
                        static_cast<int32_t*>(y)[(size_t)m * N + n] = s;
                }
            }
        }
    }
}

template <bool VEC>
void launch(const int8_t* x, const int8_t* w, void* y, int M, int K, int N,
            int fuse, float tau, cudaStream_t s)
{
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (fuse)
        boolean_matmul_kernel<VEC, true><<<grid, THREADS, 0, s>>>(x, w, y, M, K, N, tau);
    else
        boolean_matmul_kernel<VEC, false><<<grid, THREADS, 0, s>>>(x, w, y, M, K, N, tau);
}

}  // namespace

extern "C" {

// x: (M, K) int8; w: (K, N) int8; y: (M, N) int32 counts, or int8 +-1
// (s >= tau) when fuse != 0. All row-major and contiguous. Returns
// cudaGetLastError() after the launch.
int boolean_matmul(const int8_t* x, const int8_t* w, void* y, int M, int K,
                   int N, int fuse, float tau, void* stream)
{
    if (M <= 0 || K <= 0 || N <= 0 || (M + BM - 1) / BM > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const bool vec = (K % 16 == 0) && (N % 4 == 0)
        && (reinterpret_cast<uintptr_t>(x) % 16 == 0)
        && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
    if (vec)
        launch<true>(x, w, y, M, K, N, fuse, tau, s);
    else
        launch<false>(x, w, y, M, K, N, fuse, tau, s);
    return (int)cudaGetLastError();
}

const char* boolean_matmul_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
