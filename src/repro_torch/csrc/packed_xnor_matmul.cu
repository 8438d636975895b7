// Bit-packed XNOR-popcount GEMM for Hopper (sm_90a):
//
//   s[i,j] = k_valid - 2 * sum_w popcount(x[i,w] XOR w[w,j])
//
// x: (M, Kw) words packed along K (row-major), w: (Kw, N) words packed along
// K (row-major, so a row of w is contiguous along N); bit b of word j is
// element 32j + b, bit 1 = T (+1). With the pad bits past k_valid F (0) on
// both sides, s is the +-1 product sum_k e(x[i,k]) * e(w[k,j]) over the
// k_valid real bits. Words are int32 in PyTorch and read here as uint32_t.
//
// Replaces the TPU kernel src/repro/kernels/packed_xnor.py::packed_xnor_matmul
// (body _xnor_kernel), whose grid walks Kw innermost and carries an int32
// (bm, bn) sum of popcounts in VMEM scratch.
//
// What bounds it on the H100. It moves 4*(M + N)*Kw bytes of words in and
// 4*M*N bytes of int32 counts out (at VGG's first +-1 layer the output, 26
// MB, outweighs the packed operands, 3.7 MB); the same function on the int8
// tensor cores is 2*M*N*K operations at 1,979 TOPS. This kernel runs on the
// CUDA cores, where each 32-bit word pair costs one XOR, one population
// count and one add, and the population count is the slow one (16 a clock
// an SM on compute capability 9.0, NVIDIA's CUDA C++ Programming Guide):
// it stays above both bounds by design. Binary tensor-core mma (b1 XOR/AND
// popc) is later work.
//
// Design:
//  * a block of 256 threads owns a 128 x 128 output tile and walks all of Kw
//    itself in slabs of 8 words, so every output is one thread's sum: no
//    atomics, no second pass, results repeat exactly;
//  * each slab of x (128 rows x 8 words) is read with 8 neighbouring lanes on
//    one row's 8 words and stored transposed, [word][row] (rows padded to
//    132 words: conflict-free stores), so a thread reads its 4 + 4 rows as
//    two 16-byte loads; each slab of w (8 words x 128 columns) is read along
//    N and stored as it is;
//  * each thread keeps an 8 x 8 tile of int32 popcount sums: rows
//    {ty*4 .. ty*4+3, 64+ty*4 .. 64+ty*4+3} and the same pattern of columns;
//  * the next slab is read into registers while the current one is summed,
//    and shared memory is double-buffered, so one barrier a slab suffices;
//  * rows past M and words past Kw stage as 0 in both operands (zero XOR
//    zero adds nothing, as the reference's zero padding), and outputs past M
//    or N are not written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;                  // output rows per block
constexpr int BN = 128;                  // output columns per block
constexpr int BKW = 8;                   // words per slab
constexpr int XS = BM + 4;               // words per staged x row (padded)
constexpr int PER = BKW * BM / THREADS;  // slab words each thread stages (4)

__global__ void __launch_bounds__(THREADS)
packed_xnor_matmul_kernel(const uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ w,
                          int32_t* __restrict__ y, int M, int Kw, int N,
                          int k_valid)
{
    __shared__ __align__(16) uint32_t xs[2][BKW][XS];
    __shared__ __align__(16) uint32_t ws[2][BKW][BN];

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    uint32_t xr[PER], wr[PER];
    auto load = [&](int kb) {
#pragma unroll
        for (int r = 0; r < PER; ++r) {
            const int e = tid + THREADS * r;
            const int m = m0 + e / BKW, kx = kb + e % BKW;
            xr[r] = (m < M && kx < Kw) ? __ldg(x + (size_t)m * Kw + kx) : 0u;
            const int kw = kb + e / BN, n = n0 + e % BN;
            wr[r] = (kw < Kw && n < N) ? __ldg(w + (size_t)kw * N + n) : 0u;
        }
    };
    auto store = [&](int buf) {
#pragma unroll
        for (int r = 0; r < PER; ++r) {
            const int e = tid + THREADS * r;
            xs[buf][e % BKW][e / BKW] = xr[r];
            ws[buf][e / BN][e % BN] = wr[r];
        }
    };

    int acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0;

    load(0);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int kb = 0; kb < Kw; kb += BKW) {
        const bool more = kb + BKW < Kw;
        if (more) load(kb + BKW);         // in flight while this slab is summed
#pragma unroll
        for (int k = 0; k < BKW; ++k) {
            const uint4 a0 = *reinterpret_cast<const uint4*>(&xs[buf][k][ty * 4]);
            const uint4 a1 = *reinterpret_cast<const uint4*>(&xs[buf][k][64 + ty * 4]);
            const uint4 b0 = *reinterpret_cast<const uint4*>(&ws[buf][k][tx * 4]);
            const uint4 b1 = *reinterpret_cast<const uint4*>(&ws[buf][k][64 + tx * 4]);
            const uint32_t a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const uint32_t b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] += __popc(a[i] ^ b[j]);
        }
        if (more) {
            store(buf ^ 1);               // the other buffer: nobody reads it now
            __syncthreads();
            buf ^= 1;
        }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        if (m >= M) continue;
        int32_t* row = y + (size_t)m * N;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
            if (n < N) row[n] = k_valid - 2 * acc[i][j];
        }
    }
}

}  // namespace

extern "C" {

// x: (M, Kw) and w: (Kw, N) packed words, row-major and contiguous; y: (M, N)
// int32. Returns cudaGetLastError() after the launch.
int packed_xnor_matmul(const int32_t* x, const int32_t* w, int32_t* y, int M,
                       int Kw, int N, int k_valid, void* stream)
{
    if (M <= 0 || Kw <= 0 || N <= 0 || (M + BM - 1) / BM > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    packed_xnor_matmul_kernel<<<grid, THREADS, 0, s>>>(
        reinterpret_cast<const uint32_t*>(x), reinterpret_cast<const uint32_t*>(w),
        y, M, Kw, N, k_valid);
    return (int)cudaGetLastError();
}

const char* packed_xnor_matmul_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
