// Packed-XNOR GEMV for Hopper (sm_90a): y[M,N] = sum_k x[M,k] * e(w[k,N]).
//
// Replaces the TPU kernel src/repro/kernels/packed_xnor.py::packed_xnor_gemv
// (body _xnor_gemv_kernel). The Boolean weight is bit-packed along K: word
// (j, n) holds elements k = 32j .. 32j+31 of column n, bit b = element 32j+b,
// bit 1 = +1 (T), bit 0 = -1 (F). Activations are real (bf16 or fp32) and the
// sum is taken in fp32, as in the reference.
//
// What bounds it on the H100. At decode M (8 lanes) the floor is the packed
// weight words plus x and y over 3.35 TB/s (10.9 MB of words a gemma2-2b
// layer, 0.0036 ms, 16x less than the bf16 weight); at prefill M (<= 256
// rows, PACKED_GEMV_MAX_M) it is the M*K*N products at the bf16
// tensor-core rate (989 TFLOP/s). Two routes, one library; the wrapper picks
// one before launching from dtype, shapes and addresses
// (kernels/packed_xnor.py::gemv_route):
//
// Tensor cores (xnor_gemv_tc): bf16 x, K a multiple of 8 and N of 4,
// 16-byte-aligned bases -- every launch of the bf16 serving path. It
// computes y^T = e(W)^T x^T: the weight columns are the MMA's 64-row side,
// the lanes or prompt rows its N side. A bf16 x (+-1) product is
// exact in fp32, so it sums the same products as the CUDA cores, in
// another order.
//  * e(W)^T is K-major as the words lie (a word is 32 consecutive k of one
//    column), so the A operand comes from registers: each thread reads the
//    word of each of its two fragment rows and turns the bits of its
//    fragment into bf16 +-1 pairs (0xBF80 is -1; one multiply moves two
//    bits to the two sign bits, one logic operation flips them in): nothing
//    is expanded into shared memory, so a word costs 4 bytes of
//    shared-memory traffic, not 64;
//  * a block owns 128 weight columns and a tile of LANES rows of x (8, 16,
//    32, 64 or 128, the narrowest that covers M, tiled over grid.y above
//    128), and walks its share of K in stages of 4 words (128 k): a
//    producer warp keeps a ring of 4-8 stages full by TMA (x in two 64-k
//    boxes, 128B-swizzled; the words in one unswizzled 4 x 128 box),
//    mbarrier expect-tx per stage, the consumers arrive on the stage's
//    "empty" barrier once they are done with it;
//  * two consumer warpgroups of 64 columns run wgmma.m64nNk16 with N =
//    LANES, x as the K-major B operand straight from the ring; each
//    stage's group is waited for before the next stage's fragments are
//    built, as they live in registers the wgmma reads;
//  * TMA zero-fills x past M and past K, so pad bits and the words past Kw
//    multiply 0 (the reference zero-pads x the same way); the epilogue
//    masks rows past M and columns past N;
//  * decode is byte- and latency-bound and N = 2304 is only 18 blocks of
//    128 columns, so K is split over grid.z until the blocks fill one wave
//    (3 an SM at 8 lanes, 2 up to 64, 1 at 128); the host makes each split
//    a multiple of 4 words, so no stage crosses into the next split. Each
//    split writes its own fp32 partial (M, N) slab and a second kernel sums
//    the slabs in split order, so results repeat exactly (no atomics).
//
// CUDA cores (xnor_gemv): fp32 x (the bf16 tensor cores would round it: a
// different function), and bf16 x whose rows TMA cannot describe. The small
// fp32 card-vs-CPU models run through it.
//  * a block owns BN = 256 output columns (2 per thread, read as one 8-byte
//    word pair so a warp reads 256 contiguous bytes of a packed row) and
//    BM = 8 activation rows; M above 8 tiles over grid.z;
//  * K is split over grid.y until ~264 blocks fill the card, with the same
//    deterministic second pass;
//  * the block stages its x tile [BM, <=1024 k] in shared memory as fp32;
//    rows past M and k past k_valid are staged as 0, because a pad weight
//    bit is F = -1, not 0;
//  * each thread adds +-x with fp32 FMAs over its 8 x 2 outputs;
//  * words are read through uint32_t, so bit 31 of the int32 storage is an
//    ordinary bit.
#include <cuda_bf16.h>

#include "hopper_gemm.cuh"

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


// ---------------------------------------------------------------------------
// tensor-core route
// ---------------------------------------------------------------------------
constexpr int TC_KS = 4;                 // words a stage (128 k)
constexpr int TC_COLS = 128;             // weight columns a block
constexpr int TC_THREADS = 288;          // two consumer warpgroups + a producer warp
// By lane tile (rows of x a block, ascending): the lane tile, the blocks an
// SM and the ring's stages. kernels/packed_xnor.py reads TC_KS, TC_COLS and
// this table from this text to plan a traced launch, where no library is
// built; the library reports them (xnor_gemv_tc_tiles) for a launch.
constexpr int TC_TILES[5][3] = {{8, 3, 8}, {16, 2, 8}, {32, 2, 6}, {64, 2, 4}, {128, 1, 4}};

// bits 0 and 1 of u as a bf16 pair (low half from bit 0): +1 where set, -1
// where clear
__device__ __forceinline__ uint32_t pm1_pair(uint32_t u)
{
    return 0xBF80BF80u ^ (((u & 3u) * 0x40008000u) & 0x80008000u);
}

// The A fragment of k16 step h (0: bits 0..15, 1: bits 16..31) of the words
// u0, u1 of a thread's two fragment rows, each already shifted right by 2q.
__device__ __forceinline__ void fragment(uint32_t (&a)[4], uint32_t u0,
                                         uint32_t u1, int h)
{
    a[0] = pm1_pair(u0 >> (16 * h));
    a[1] = pm1_pair(u1 >> (16 * h));
    a[2] = pm1_pair(u0 >> (16 * h + 8));
    a[3] = pm1_pair(u1 >> (16 * h + 8));
}

// One stage: x as two 64-k boxes of LANES rows (128B-swizzled, the layout
// of a K-major wgmma operand), then the words as one 4 x 128 box.
template <int LANES>
struct Ring {
    static constexpr int ROW = LANES == 8 ? 0 : LANES == 16 ? 1 : LANES == 32 ? 2
                               : LANES == 64 ? 3 : 4;
    static_assert(TC_TILES[ROW][0] == LANES, "no such lane tile");
    static constexpr int X_BOX = LANES * 128;
    static constexpr int STAGE = 2 * X_BOX + TC_KS * TC_COLS * 4;
    static constexpr int STAGES = TC_TILES[ROW][2];
    static constexpr int BLOCKS = TC_TILES[ROW][1];
    static constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// A block owns TC_COLS weight columns and LANES rows of x: thread 256 keeps
// the ring full for the kt_n stages of the block's K split; each of two
// consumer warpgroups owns 64 weight columns, builds the stage's A
// fragments in registers from the words, issues 8 wgmma k16 steps on the
// stage's x boxes and waits for them (the fragments' registers are the next
// stage's) before releasing the stage.
template <int LANES>
__global__ void __launch_bounds__(TC_THREADS, Ring<LANES>::BLOCKS)
xnor_gemv_tc_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    float* __restrict__ out, int M, int N, int Kw, int kws)
{
    using R = Ring<LANES>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = hopper::align_1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
    uint64_t* empty = full + R::STAGES;
    const int n0 = blockIdx.x * TC_COLS, m0 = blockIdx.y * LANES;
    const int split = blockIdx.z, kw0 = split * kws;
    const int kt_n = (min(kws, Kw - kw0) + TC_KS - 1) / TC_KS;
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < R::STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);      // the producer's arrive + bytes
            hopper::mbar_init(&empty[s], 2);     // one arrive a warpgroup
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x >= 256) {
        if (threadIdx.x == 256) {
            for (int kt = 0; kt < kt_n; ++kt) {
                const int s = kt % R::STAGES;
                if (kt >= R::STAGES)
                    hopper::mbar_wait(&empty[s], ((kt / R::STAGES) & 1) ^ 1);
                hopper::mbar_arrive_expect_tx(&full[s], R::STAGE);
                uint8_t* st = ring + s * R::STAGE;
                const int kw = kw0 + kt * TC_KS;
                hopper::tma_load_2d(st, &tx, &full[s], 32 * kw, m0);
                hopper::tma_load_2d(st + R::X_BOX, &tx, &full[s], 32 * kw + 64, m0);
                hopper::tma_load_2d(st + 2 * R::X_BOX, &tw, &full[s], n0, kw);
            }
        }
        return;
    }

    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int row = 64 * wg + 16 * (t / 32) + (t % 32) / 4;  // fragment row 0
    const int q2 = 2 * (t % 4);
    float acc[LANES / 2];
#pragma unroll
    for (int i = 0; i < LANES / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % R::STAGES;
        hopper::mbar_wait(&full[s], (kt / R::STAGES) & 1);
        const uint8_t* st = ring + s * R::STAGE;
        const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + 2 * R::X_BOX);
        uint32_t a[2 * TC_KS][4];
#pragma unroll
        for (int j = 0; j < TC_KS; ++j) {
            const uint32_t u0 = ws[j * TC_COLS + row] >> q2;
            const uint32_t u1 = ws[j * TC_COLS + row + 8] >> q2;
            fragment(a[2 * j], u0, u1, 0);
            fragment(a[2 * j + 1], u0, u1, 1);
        }
        const uint32_t xb = hopper::smem_addr(st);
        hopper::fence_acc(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 2 * TC_KS; ++ks)
            hopper::wgmma_rs(acc, a[ks], hopper::desc_sw128(
                xb + (ks / 4) * R::X_BOX + 32 * (ks % 4), 16, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(acc);
        if (t == 0)
            hopper::mbar_arrive(&empty[s]);
    }

    // acc[4j + 2h + e] = D[row + 8h][8j + q2 + e]: weight column n0 + row +
    // 8h, lane m0 + 8j + q2 + e
    float* o = out + (size_t)split * M * N;
#pragma unroll
    for (int j = 0; j < LANES / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * j + q2 + e;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int n = n0 + row + 8 * h;
                if (m < M && n < N)
                    o[(size_t)m * N + n] = acc[4 * j + 2 * h + e];
            }
        }
}

template <int LANES>
cudaError_t launch_tc(const void* x, const int32_t* w, float* out, int M,
                      int K, int Kw, int N, int ksplit, int kws, cudaStream_t s)
{
    using R = Ring<LANES>;
    static_assert((R::SMEM + 1024) * R::BLOCKS <= 233472,
                  "the ring does not fit in shared memory");
    const auto kernel = xnor_gemv_tc_kernel<LANES>;
    CUtensorMap tx, tw;
    cudaError_t e = hopper::make_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                     M, K, LANES);
    if (e == cudaSuccess)
        e = hopper::make_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, Kw, N,
                             TC_KS, false, TC_COLS);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)R::SMEM);
    if (e != cudaSuccess)
        return e;
    const dim3 grid((N + TC_COLS - 1) / TC_COLS, (M + LANES - 1) / LANES, ksplit);
    kernel<<<grid, TC_THREADS, R::SMEM, s>>>(tx, tw, out, M, N, Kw, kws);
    return cudaGetLastError();
}

template <int LANES>
void tile(int* t)
{
    using R = Ring<LANES>;
    t[0] = LANES;
    t[1] = R::BLOCKS;
    t[2] = R::STAGES;
    t[3] = (int)R::SMEM;
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

// The tensor-core route: x (M, K) bf16, K a multiple of 8, 16-byte-aligned;
// w: (Kw, N) packed words, N a multiple of 4, 16-byte-aligned; lanes (8, 16,
// 32, 64 or 128) rows of x a block; kws words per split, a
// multiple of 4 unless ksplit == 1, ksplit * kws >= Kw > (ksplit - 1) * kws;
// y and part as above. Returns cudaGetLastError() after the launches, or the
// error that kept them from running.
int xnor_gemv_tc(const void* x, const int32_t* w, float* y, float* part,
                 int M, int K, int Kw, int N, int lanes, int ksplit, int kws,
                 void* stream)
{
    if (M <= 0 || K <= 0 || N <= 0 || ksplit < 1 || kws < 1
        || (ksplit > 1 && kws % TC_KS != 0) || (long long)ksplit * kws < Kw
        || (long long)(ksplit - 1) * kws >= Kw || 32LL * Kw < K
        || (M + lanes - 1) / lanes > 65535 || ksplit > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    float* out = ksplit > 1 ? part : y;
    cudaError_t e;
    switch (lanes) {
    case 8: e = launch_tc<8>(x, w, out, M, K, Kw, N, ksplit, kws, s); break;
    case 16: e = launch_tc<16>(x, w, out, M, K, Kw, N, ksplit, kws, s); break;
    case 32: e = launch_tc<32>(x, w, out, M, K, Kw, N, ksplit, kws, s); break;
    case 64: e = launch_tc<64>(x, w, out, M, K, Kw, N, ksplit, kws, s); break;
    case 128: e = launch_tc<128>(x, w, out, M, K, Kw, N, ksplit, kws, s); break;
    default: return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess)
        return (int)e;
    if (ksplit > 1) {
        const long long mn = (long long)M * N;
        const int t = 256;
        xnor_gemv_reduce<<<(unsigned)((mn + t - 1) / t), t, 0, s>>>(part, y, mn, ksplit);
    }
    return (int)cudaGetLastError();
}

// The tensor-core kernels' tiles, which the host's K split and reports
// read: out[0] words a stage, out[1] weight columns a block, then for each
// lane tile its rows of x, blocks an SM, ring stages and dynamic shared
// bytes (out holds 2 + 4 * 5 ints). Returns the number of lane tiles.
int xnor_gemv_tc_tiles(int* out)
{
    out[0] = TC_KS;
    out[1] = TC_COLS;
    int* t = out + 2;
    tile<8>(t);
    tile<16>(t + 4);
    tile<32>(t + 8);
    tile<64>(t + 12);
    tile<128>(t + 16);
    return 5;
}

const char* xnor_gemv_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
