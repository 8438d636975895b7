// Fused Boolean-variation weight backward for Hopper (sm_90a), paper Eq 5/7:
//
//   G_W[i,j] = sum_k x[k,i] * z[k,j] * (1 - tanh^2(alpha * d[k,j]))
//
// the mask skipped when alpha == 0. x: (B, M) int8 +-1, bf16 or fp32; z and
// d: (B, N) bf16 or fp32 (d of z's type); G_W: (M, N) fp32. Both operands
// are contracted over their leading B (token) axis, so G_W = X^T Z~.
//
// Replaces the TPU kernel src/repro/kernels/boolean_bwd.py::boolean_weight_bwd
// (body _bwd_kernel), whose grid walks B innermost and carries the (bm, bn)
// sum in VMEM scratch from one grid step to the next.
//
// What bounds it on the H100. At the training path's shapes (B = 1024
// tokens, M and N in the thousands) it does 2*B*M*N operations on
// B*(M+N) + M*N inputs and outputs: hundreds of operations per byte, so it
// is bound by operations, at the bf16 tensor-core rate (989 TFLOP/s); the
// fp32 output is the larger part of its bytes (one gemma2-2b layer's seven
// votes write 349 MB, 0.104 ms at 3.35 TB/s, against 0.181 ms of
// operations), so its stores have to stream too.
//
// Two routes, one library; the wrapper picks one from dtype, alpha and
// alignment before launching (kernels/boolean_bwd.py::weight_bwd_route):
//
// Tensor cores (boolean_weight_bwd_tc): x and z bf16, alpha == 0, M and N
// multiples of 8, 16-byte-aligned bases -- every launch of the training
// path. A bf16 x bf16 product is exact in fp32, so wgmma gives the same
// products as the CUDA cores, summed in fp32 in another order.
//  * G = X^T Z contracts the leading axis of both row-major operands: as
//    wgmma operands A = X^T and B = Z are both MN-major (the transpose bits
//    of wgmma.m64n256k16.f32.bf16.bf16), so nothing is transposed in memory;
//  * a block owns a 128 x 256 output tile and walks B in tiles of 64
//    tokens: TMA brings 64-token x 64-column boxes (128-byte rows, 128B
//    swizzle) of x (2) and z (4) into a ring of 4 stages of 48 KB
//    (hopper_gemm.cuh's ring_kernel, one block an SM); each consumer
//    warpgroup issues 4 wgmma m64n256k16 steps a stage on its 64 rows,
//    128 fp32 accumulators a thread: the widest tile wgmma offers, so the
//    fewest operand bytes are brought in per operation;
//  * each output is one warpgroup's sum over B in a fixed order: no split-K,
//    no atomics, repeatable from run to run;
//  * TMA zero-fills tokens past B and columns past M and N; the epilogue
//    stores each thread's pairs of neighbouring fp32 columns as 8-byte
//    stores (four threads cover a 32-byte sector of a row), masked at the
//    edges.
//
// CUDA cores (boolean_weight_bwd): every other case -- fp32 or int8 x, fp32
// z, alpha > 0 (the tanh' mask is formed as z is staged), and bf16 shapes
// whose rows TMA cannot describe. None of these is launched by the training
// path; the card-vs-CPU checks run fp32 through it.
//  * a block of 256 threads owns a 128 x 128 output tile and walks all of B
//    itself in slabs of 8 rows, so every output element is one thread's
//    sequential fp32 sum over k = 0..B-1: no atomics, no second pass, and
//    the result repeats exactly from run to run;
//  * each slab of x (8 x 128) and z (8 x 128) is read from device memory
//    with neighbouring threads on neighbouring columns (rows are contiguous
//    along M and N), widened to fp32 and stored in shared memory; when
//    alpha > 0 the d slab is read beside z and z~ = z * (1 - tanh^2(alpha*d))
//    is formed as it is staged (tanhf, no fast-math);
//  * the next slab is read into registers while the current one is summed,
//    and shared memory is double-buffered, so one barrier a slab suffices;
//  * each thread keeps an 8 x 8 register tile of fp32 sums (at most 128
//    registers, so two blocks share an SM; the 8-row slab keeps the staging
//    registers few enough that little spills): rows
//    {ty*4 .. ty*4+3, 64+ty*4 .. 64+ty*4+3} and the same pattern of columns,
//    read from shared memory as float4 without bank conflicts;
//  * bounds checks take the place of the reference's zero padding: rows past
//    B stage as 0 in both operands, and columns past M or N are not written.
#include <cuda_bf16.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;                  // output rows (x columns) per block
constexpr int BN = 128;                  // output columns (z columns) per block
constexpr int BK = 8;                    // B rows per slab
constexpr int PER = BK * BM / THREADS;   // slab elements each thread stages (4)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename TX, typename TZ, bool MASK>
__global__ void __launch_bounds__(THREADS, 2)
weight_bwd_kernel(const TX* __restrict__ x, const TZ* __restrict__ z,
                  const TZ* __restrict__ d, float* __restrict__ out,
                  int B, int M, int N, float alpha)
{
    __shared__ __align__(16) float xs[2][BK][BM];
    __shared__ __align__(16) float zs[2][BK][BN];

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    // staging map: element e = tid + THREADS * r of a slab is row e / 128,
    // column e % 128; a warp reads 32 neighbouring columns of one row
    float xr[PER], zr[PER];
    auto load = [&](int kb) {
#pragma unroll
        for (int r = 0; r < PER; ++r) {
            const int e = tid + THREADS * r;
            const int k = kb + e / BM, c = e % BM;
            const bool krow = k < B;
            const int m = m0 + c, n = n0 + c;
            xr[r] = (krow && m < M) ? to_f32(x[(size_t)k * M + m]) : 0.f;
            float zv = 0.f;
            if (krow && n < N) {
                zv = to_f32(z[(size_t)k * N + n]);
                if (MASK) {
                    const float t = tanhf(alpha * to_f32(d[(size_t)k * N + n]));
                    zv = zv * (1.f - t * t);
                }
            }
            zr[r] = zv;
        }
    };
    auto store = [&](int buf) {
#pragma unroll
        for (int r = 0; r < PER; ++r) {
            const int e = tid + THREADS * r;
            xs[buf][e / BM][e % BM] = xr[r];
            zs[buf][e / BN][e % BN] = zr[r];
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load(0);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int kb = 0; kb < B; kb += BK) {
        const bool more = kb + BK < B;
        if (more) load(kb + BK);          // in flight while this slab is summed
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][k][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&xs[buf][k][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&zs[buf][k][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&zs[buf][k][64 + tx * 4]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
        float* row = out + (size_t)m * N;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
            if (n < N) row[n] = acc[i][j];
        }
    }
}

template <typename TX, typename TZ>
void launch(const void* x, const void* z, const void* d, float* y, int B, int M,
            int N, float alpha, cudaStream_t s)
{
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const TX* xp = static_cast<const TX*>(x);
    const TZ* zp = static_cast<const TZ*>(z);
    const TZ* dp = static_cast<const TZ*>(d);
    if (alpha > 0.f)
        weight_bwd_kernel<TX, TZ, true><<<grid, THREADS, 0, s>>>(xp, zp, dp, y, B, M, N, alpha);
    else
        weight_bwd_kernel<TX, TZ, false><<<grid, THREADS, 0, s>>>(xp, zp, dp, y, B, M, N, 0.f);
}

template <typename TX>
void launch_z(const void* x, int z_type, const void* z, const void* d, float* y,
              int B, int M, int N, float alpha, cudaStream_t s)
{
    if (z_type == 1)
        launch<TX, __nv_bfloat16>(x, z, d, y, B, M, N, alpha, s);
    else
        launch<TX, float>(x, z, d, y, B, M, N, alpha, s);
}


constexpr int TOKENS = 64;              // B rows a stage: 64 x 128-byte rows a box
constexpr uint32_t BOX = TOKENS * 128;  // one 64-token x 64-column bf16 box

template <int BN_, int STAGES_, int BLOCKS_>
struct weight_bwd_tc {
    static constexpr int BN = BN_;
    static constexpr int STAGES = STAGES_;
    static constexpr int BLOCKS = BLOCKS_;
    static constexpr uint32_t A_BYTES = 2 * BOX;          // 128 columns of x
    static constexpr uint32_t B_BYTES = (BN / 64) * BOX;  // BN columns of z
    static constexpr uint32_t A_WG = BOX;
    struct Args {
        float* y;
        int B, M, N;
    };
    using Acc = float[BN / 2];

    __device__ static int k_tiles(const Args& a) { return (a.B + TOKENS - 1) / TOKENS; }

    __device__ static void load(uint8_t* a, uint8_t* b, const CUtensorMap* ta,
                                const CUtensorMap* tb, uint64_t* bar, int kt,
                                int m0, int n0)
    {
        const int k0 = kt * TOKENS;
        hopper::tma_load_2d(a, ta, bar, m0, k0);
        hopper::tma_load_2d(a + BOX, ta, bar, m0 + 64, k0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load_2d(b + j * BOX, tb, bar, n0 + 64 * j, k0);
    }

    // MN-major operands: a k16 step is 16 rows of 128 bytes; A spans one
    // 64-column block, B spans BN / 64 of them, BOX bytes apart (LBO)
    __device__ static void mma(Acc& d, uint32_t a, uint32_t b)
    {
#pragma unroll
        for (int ks = 0; ks < TOKENS / 16; ++ks)
            hopper::wgmma_bf16<1, 1>(d, hopper::desc_sw128(a + 2048 * ks, BOX, 1024),
                                     hopper::desc_sw128(b + 2048 * ks, BOX, 1024));
    }

    __device__ static void store(const Acc& d, const Args& args, int row0,
                                 int n0, int t)
    {
        const int r0 = row0 + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int n = n0 + 8 * j + 2 * (t % 4);
            if (n >= args.N)                       // N % 8 == 0: n + 1 < N
                continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = r0 + 8 * h;
                if (m < args.M)
                    *reinterpret_cast<float2*>(args.y + (size_t)m * args.N + n) =
                        make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
            }
        }
    }
};

}  // namespace

extern "C" {

// x: (B, M), x_type 0 = int8, 1 = bf16, 2 = fp32; z: (B, N), z_type 1 = bf16,
// 2 = fp32; d: (B, N) of z's type, read only when alpha > 0 (may be null
// otherwise); y: (M, N) fp32. All row-major and contiguous. Returns
// cudaGetLastError() after the launch.
int boolean_weight_bwd(const void* x, int x_type, const void* z, int z_type,
                       const void* d, float* y, int B, int M, int N, float alpha,
                       void* stream)
{
    if (B < 0 || M <= 0 || N <= 0 || x_type < 0 || x_type > 2 || z_type < 1
        || z_type > 2 || (alpha > 0.f && d == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (x_type == 0)
        launch_z<int8_t>(x, z_type, z, d, y, B, M, N, alpha, s);
    else if (x_type == 1)
        launch_z<__nv_bfloat16>(x, z_type, z, d, y, B, M, N, alpha, s);
    else
        launch_z<float>(x, z_type, z, d, y, B, M, N, alpha, s);
    return (int)cudaGetLastError();
}

// The tensor-core route: x: (B, M) bf16; z: (B, N) bf16; y: (M, N) fp32;
// alpha = 0. Row-major and contiguous, B >= 1, M and N multiples of 8, x and
// z 16-byte aligned (TMA). Returns cudaGetLastError() after the launch, or
// the error that kept it from one.
int boolean_weight_bwd_tc(const void* x, const void* z, float* y, int B, int M,
                          int N, void* stream)
{
    if (B <= 0 || M <= 0 || N <= 0 || M % 8 != 0 || N % 8 != 0
        || (M + hopper::BM - 1) / hopper::BM > 65535)
        return (int)cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    cudaError_t e = hopper::make_map(&ta, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                     B, M, TOKENS);
    if (e == cudaSuccess)
        e = hopper::make_map(&tb, z, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, N,
                             TOKENS);
    if (e != cudaSuccess)
        return (int)e;
    using P = weight_bwd_tc<256, 4, 1>;
    return (int)hopper::launch<P>(ta, tb, P::Args{y, B, M, N}, M, N,
                                  reinterpret_cast<cudaStream_t>(stream));
}

const char* boolean_weight_bwd_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
