// Bit-packed XNOR-popcount GEMM for Hopper (sm_90a), on the binary tensor
// cores:
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
// MB, outweighs the packed operands, 3.7 MB); its 2*M*N*32*Kw operations
// take 1,979 TOPS on the int8 tensor cores and run 8x as fast on the binary
// ones (tc_rate_probe below; NVIDIA publishes no b1 rate for Hopper), so the
// bytes bound it at VGG's shapes. Population counts on the CUDA cores (16 a
// clock an SM) reach neither bound, and expanding
// the words into +-1 int8 operands on chip is bound by the expansion
// (measured: 0.166 ms for the four VGG GEMMs, 2.5x the tensor time a
// stage). The binary tensor cores take the words as they are:
// wgmma.m64nNk256.s32.b1.b1.and.popc sums popcount(x AND w), and
//   popcount(x XOR w) = popcount(x) + popcount(w) - 2 popcount(x AND w),
// so s = k_valid - 2 pop(x row) - 2 pop(w column) + 4 P with P the AND sum
// over all 32*Kw bits: exact, whatever the pad bits hold.
//
// Design:
//  * a block of two warpgroups owns a 128 x BN output tile, BN = 64 where
//    that covers N, else 128, and walks Kw in stages of 32 words (1,024 k,
//    one 128-byte row of a 128B-swizzled K-major wgmma operand: 4 k256
//    steps a stage);
//  * every thread loads its share of the stage's words from device memory
//    with ordinary loads (no TMA: a row of x is 4*Kw bytes, 72 at
//    SMALL-EDSR, and w must be turned K-major, a row of it 280 bytes at the
//    ragged shape): two threads a row of x, 16 words each as four 16-byte
//    loads where the row allows; w along N, one column a thread, stored to
//    the column's row of the stage (the word order within a row is the
//    same for x and w, so every bit meets its partner);
//  * each thread adds the popcounts of the words it loads, so the block
//    has its rows' and columns' popcounts when the K loop ends; words past
//    Kw and rows and columns past the edges load as 0 (adding to neither
//    P nor the popcounts), and outputs past M or N are not written;
//  * shared memory holds two stages: while the tensor cores run stage kt
//    (each warpgroup 4 k256 steps on its 64 rows, int32 sums in
//    registers), the threads store stage kt + 1 into the other buffer and
//    load stage kt + 2 into registers, then wait for their wgmma group and
//    meet at one barrier. The last stage issues only the k256 steps that
//    hold words, as its own pipeline stage (a wgmma group under a branch
//    would be serialised);
//  * every output is one warpgroup's sum over all of Kw in one fixed
//    order: no atomics, no second pass, results repeat exactly; the
//    epilogue writes each thread's pairs of neighbouring int32 columns as
//    one 8-byte store (four threads fill a row's 32-byte sector).
#include <type_traits>

#include "hopper_gemm.cuh"

namespace {

constexpr int THREADS = 256;             // two consumer warpgroups
constexpr int SKW = 32;                  // words a stage along K
constexpr int ROW = 4 * SKW;             // bytes of a stage row: one 128B row
constexpr int A_BYTES = hopper::BM * ROW;

// d (64 x N, int32) += popcount(A (64 x 256 bits) AND B (256 bits x N)),
// both operands K-major in shared memory by descriptor; the accumulator
// fragment of hopper_gemm.cuh's wgmma_s8.
__device__ __forceinline__ void wgmma_b1(int (&d)[32], uint64_t da, uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_b1(int (&d)[64], uint64_t da, uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
packed_xnor_matmul_tc(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ w, int32_t* __restrict__ y,
                      int M, int Kw, int N, int k_valid)
{
    constexpr int STAGE = A_BYTES + BN * ROW;
    constexpr int WW = BN * SKW / THREADS;           // w words a thread a stage
    extern __shared__ uint8_t smem_raw[];
    __shared__ int rowpop[hopper::BM], colpop[THREADS / BN][BN];
    uint8_t* stage0 = hopper::align_1024(smem_raw);
    const int tid = threadIdx.x, t = tid % 128, wg = tid / 128;
    const int m0 = blockIdx.y * hopper::BM, n0 = blockIdx.x * BN;
    const int kt_n = (Kw + SKW - 1) / SKW;

    // x: words 16h .. 16h+15 of the stage of tile row xrow; w: column n0 +
    // tid % BN, words tid / BN, + THREADS / BN, ... of the stage
    const int xrow = tid / 2, xh = tid % 2;
    const bool xin = m0 + xrow < M;
    const uint32_t* xp = x + (size_t)min(m0 + xrow, M - 1) * Kw;
    const bool vec = Kw % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const int wn = n0 + tid % BN;
    uint32_t xr[16], wr[WW];
    int xpop = 0, wpop = 0;
    auto load = [&](int kt) {
        const int kw0 = kt * SKW + 16 * xh;
        if (xin && vec && kw0 + 16 <= Kw) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                const uint4 q = __ldg(reinterpret_cast<const uint4*>(xp + kw0) + v);
                xr[4 * v] = q.x;
                xr[4 * v + 1] = q.y;
                xr[4 * v + 2] = q.z;
                xr[4 * v + 3] = q.w;
            }
        } else {
#pragma unroll
            for (int i = 0; i < 16; ++i)
                xr[i] = (xin && kw0 + i < Kw) ? __ldg(xp + kw0 + i) : 0u;
        }
#pragma unroll
        for (int i = 0; i < WW; ++i) {
            const int kw = kt * SKW + tid / BN + (THREADS / BN) * i;
            wr[i] = (wn < N && kw < Kw) ? __ldg(w + (size_t)kw * N + wn) : 0u;
        }
    };
    // the registers into the stage at its 128B-swizzled places (chunk c of
    // row r at c ^ (r % 8)), counting their bits
    auto store = [&](uint8_t* st) {
        uint8_t* row = st + xrow * ROW;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            *reinterpret_cast<uint4*>(row + 16 * ((4 * xh + v) ^ (xrow & 7))) =
                make_uint4(xr[4 * v], xr[4 * v + 1], xr[4 * v + 2], xr[4 * v + 3]);
            xpop += __popc(xr[4 * v]) + __popc(xr[4 * v + 1])
                + __popc(xr[4 * v + 2]) + __popc(xr[4 * v + 3]);
        }
        const int r = tid % BN;
#pragma unroll
        for (int i = 0; i < WW; ++i) {
            const int j = tid / BN + (THREADS / BN) * i;
            *reinterpret_cast<uint32_t*>(st + A_BYTES + r * ROW
                                         + 16 * ((j / 4) ^ (r & 7)) + 4 * (j % 4)) = wr[i];
            wpop += __popc(wr[i]);
        }
    };

    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // one stage's wgmma group of NKS k256 steps, the next stage stored and
    // the one after loaded meanwhile, the group waited for
    auto stage = [&](int kt, auto nks) {
        uint8_t* cur = stage0 + (kt & 1) * STAGE;
        const uint32_t a = hopper::smem_addr(cur) + wg * 64 * ROW;
        const uint32_t b = hopper::smem_addr(cur + A_BYTES);
        hopper::fence_acc(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < decltype(nks)::value; ++ks)
            wgmma_b1(acc, hopper::desc_sw128(a + 32 * ks, 16, 1024),
                     hopper::desc_sw128(b + 32 * ks, 16, 1024));
        hopper::wgmma_commit();
        if (kt + 1 < kt_n) {
            // the other buffer: its last reader, stage kt - 1's wgmma, is done
            store(stage0 + ((kt + 1) & 1) * STAGE);
            if (kt + 2 < kt_n) load(kt + 2);
        }
        hopper::wgmma_wait<0>();
        hopper::fence_acc(acc);
        hopper::fence_proxy_async();
        __syncthreads();
    };

    load(0);
    store(stage0);
    if (kt_n > 1) load(1);
    hopper::fence_proxy_async();         // the generic stores, to wgmma
    __syncthreads();
    for (int kt = 0; kt + 1 < kt_n; ++kt)
        stage(kt, std::integral_constant<int, 4>{});
    switch ((Kw - (kt_n - 1) * SKW + 7) / 8) {   // k256 steps with words
    case 1: stage(kt_n - 1, std::integral_constant<int, 1>{}); break;
    case 2: stage(kt_n - 1, std::integral_constant<int, 2>{}); break;
    case 3: stage(kt_n - 1, std::integral_constant<int, 3>{}); break;
    default: stage(kt_n - 1, std::integral_constant<int, 4>{}); break;
    }

    // a row's two threads are neighbouring lanes; a column's THREADS / BN
    // threads are BN apart
    const int rp = xpop + __shfl_xor_sync(0xffffffffu, xpop, 1);
    if (xh == 0)
        rowpop[xrow] = rp;
    colpop[tid / BN][tid % BN] = wpop;
    __syncthreads();

    // epilogue: d[4j + 2h + e] = D[16 (t / 32) + (t % 32) / 4 + 8h][8j + 2 (t % 4) + e]
    const int rl = 64 * wg + 16 * (t / 32) + (t % 32) / 4;
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
        const int nl = 8 * j + 2 * (t % 4), n = n0 + nl;
        if (n >= N)
            continue;
        int c0 = 0, c1 = 0;
#pragma unroll
        for (int p = 0; p < THREADS / BN; ++p) {
            c0 += colpop[p][nl];
            c1 += colpop[p][nl + 1];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + rl + 8 * h;
            if (m >= M)
                continue;
            const int base = k_valid - 2 * rowpop[rl + 8 * h];
            const int s0 = base - 2 * c0 + 4 * acc[4 * j + 2 * h];
            const int s1 = base - 2 * c1 + 4 * acc[4 * j + 2 * h + 1];
            int32_t* o = y + (size_t)m * N + n;
            if (pairs) {
                *reinterpret_cast<int2*>(o) = make_int2(s0, s1);
            } else {
                o[0] = s0;
                if (n + 1 < N) o[1] = s1;
            }
        }
    }
}

template <int BN>
cudaError_t launch(const int32_t* x, const int32_t* w, int32_t* y, int M,
                   int Kw, int N, int k_valid, cudaStream_t s)
{
    constexpr size_t smem = 1024 + 2 * (A_BYTES + BN * ROW);
    static_assert(smem + 1024 + 2048 <= 233472, "two stages do not fit");
    const cudaError_t e = cudaFuncSetAttribute(
        packed_xnor_matmul_tc<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess)
        return e;
    const dim3 grid((N + BN - 1) / BN, (M + hopper::BM - 1) / hopper::BM);
    packed_xnor_matmul_tc<BN><<<grid, THREADS, smem, s>>>(
        reinterpret_cast<const uint32_t*>(x), reinterpret_cast<const uint32_t*>(w),
        y, M, Kw, N, k_valid);
    return cudaGetLastError();
}

// Rate probe of the tensor cores, for the bound this kernel is held to:
// NVIDIA publishes no b1 rate for Hopper. Two blocks an SM, each of two
// warpgroups issuing groups of 16 wgmma steps on one zeroed stage and
// waiting for each group: m64n128k256 b1 AND-popc (B1), or m64n128k32 s8,
// whose published rate (1,979 TOPS) shows how near the probe comes to a
// peak. out[block] keeps a sum, so the work is not dropped.
template <bool B1>
__global__ void __launch_bounds__(THREADS, 2)
tc_rate_probe_kernel(int groups, int32_t* out)
{
    extern __shared__ uint8_t smem_raw[];
    uint8_t* st = hopper::align_1024(smem_raw);
    for (int i = threadIdx.x; i < 2 * A_BYTES / 16; i += THREADS)
        reinterpret_cast<uint4*>(st)[i] = make_uint4(0u, 0u, 0u, 0u);
    hopper::fence_proxy_async();
    __syncthreads();
    const uint32_t a = hopper::smem_addr(st) + threadIdx.x / 128 * 64 * ROW;
    const uint32_t b = hopper::smem_addr(st + A_BYTES);
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int g = 0; g < groups; ++g) {
        hopper::fence_acc(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 16; ++ks) {
            const uint64_t da = hopper::desc_sw128(a + 32 * (ks % 4), 16, 1024);
            const uint64_t db = hopper::desc_sw128(b + 32 * (ks % 4), 16, 1024);
            if constexpr (B1)
                wgmma_b1(acc, da, db);
            else
                hopper::wgmma_s8(acc, da, db);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(acc);
    }
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) sum += acc[i];
    if (threadIdx.x == 0)
        out[blockIdx.x] = sum;
}

template <bool B1>
cudaError_t launch_probe(int blocks, int groups, int32_t* out, cudaStream_t s)
{
    constexpr size_t smem = 1024 + 2 * A_BYTES;
    const cudaError_t e = cudaFuncSetAttribute(
        tc_rate_probe_kernel<B1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess)
        return e;
    tc_rate_probe_kernel<B1><<<blocks, THREADS, smem, s>>>(groups, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (M, Kw) and w: (Kw, N) packed words, row-major and contiguous; y: (M, N)
// int32. Returns cudaGetLastError() after the launch, or the error that kept
// it from one.
int packed_xnor_matmul(const int32_t* x, const int32_t* w, int32_t* y, int M,
                       int Kw, int N, int k_valid, void* stream)
{
    if (M <= 0 || Kw <= 0 || N <= 0 || Kw > (1 << 25)
        || (M + hopper::BM - 1) / hopper::BM > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (N > 64)
        return (int)launch<128>(x, w, y, M, Kw, N, k_valid, s);
    return (int)launch<64>(x, w, y, M, Kw, N, k_valid, s);
}

// The rate probe: blocks x 2 warpgroups x groups x 16 wgmma steps of 64 x
// 128 x 256 bits (b1 != 0) or 64 x 128 x 32 int8 (b1 == 0); out: blocks
// int32. Returns cudaGetLastError() after the launch.
int tc_rate_probe(int b1, int blocks, int groups, int32_t* out, void* stream)
{
    if (blocks <= 0 || groups <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    return (int)(b1 ? launch_probe<true>(blocks, groups, out, s)
                    : launch_probe<false>(blocks, groups, out, s));
}

const char* packed_xnor_matmul_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
