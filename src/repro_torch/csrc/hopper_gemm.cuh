// Shared Hopper (sm_90a) GEMM machinery of the port's hand-written kernels:
// TMA tensor maps, mbarrier rings, wgmma descriptors and instructions, and one
// warp-specialised kernel skeleton that a kernel fills in with a policy.
//
// The skeleton (ring_kernel) computes one BM x BN output tile a block:
//  * the producer (warpgroup 2, or warp 8 at two blocks an SM) has one
//    thread walk the contraction axis in tiles and, for each, wait for a
//    free stage of a ring of STAGES shared-memory stages, arm the stage's
//    "full" barrier with the bytes to expect and issue the policy's TMA
//    loads into it (128-byte-swizzled boxes, zero-filled past the edges of
//    the tensor);
//  * warpgroups 0 and 1 are the consumers, 64 output rows each: each waits
//    on a stage's "full" barrier, issues the policy's wgmma instructions on
//    it (accumulators in registers), keeps one wgmma group in flight and
//    releases the stage before it on its "empty" barrier; at the end each
//    hands its accumulators to the policy's epilogue.
// Every output is one consumer's sum over the whole contraction axis in one
// fixed order: no split-K, no atomics, and results repeat from run to run.
//
// A policy P provides: BN, STAGES, BLOCKS (blocks an SM: 1, or 2 for tiles
// whose accumulators fit in 112 registers a thread), A_BYTES and B_BYTES
// (one stage of each operand), A_WG (the byte offset of consumer 1's rows in
// the A stage), Args (what the epilogue needs), Acc (the accumulator array),
// k_tiles(args), load(a, b, ta, tb, bar, kt, m0, n0) (the TMA loads of tile
// kt), mma(acc, a, b) (one stage's wgmma instructions for one consumer,
// shared-memory addresses) and store(acc, args, row0, n0, t) (the epilogue
// of one consumer: its rows start at row0, t is the thread in the
// warpgroup).
//
// Only the host code needs cuTensorMapEncodeTiled, a libcuda function; it is
// looked up at run time through cudaGetDriverEntryPoint, so a library links
// no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int BM = 128;                // output rows a block: 2 x 64

// A block is two consumer warpgroups (threads 0..255) and the producer after
// them. At one block an SM the producer is a whole warpgroup, so that
// setmaxnreg can move registers from it to the consumers (128 x 40 +
// 256 x 232 <= 65,536); at two blocks an SM it is one warp, and the launch
// bound leaves every thread 65,536 / (2 x 288) registers, 112 after
// rounding, no setmaxnreg needed.
template <class P>
constexpr int threads() { return P::BLOCKS == 1 ? 384 : 288; }
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled()
{
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// A 2-D map of a row-major (rows, cols) matrix of elem-byte elements, read in
// boxes of box_rows rows x 128 bytes, 128-byte swizzled (the layout of a
// wgmma operand with a 128B-swizzle descriptor); or, with swizzle false, in
// unswizzled boxes of box_rows rows x box_cols elements (read back by plain
// shared-memory loads). TMA zero-fills what lies past the matrix. TMA needs
// a 16-byte-aligned base and a row stride that is a multiple of 16 bytes:
// the wrappers check both, and so does this.
inline cudaError_t make_map(CUtensorMap* map, const void* base,
                            CUtensorMapDataType type, int elem, uint64_t rows,
                            uint64_t cols, uint32_t box_rows, bool swizzle = true,
                            uint32_t box_cols = 0)
{
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr)
        return cudaErrorNotSupported;
    if (swizzle || box_cols == 0)
        box_cols = 128u / elem;
    if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || (cols * elem) % 16 != 0
        || rows == 0 || cols == 0 || box_rows == 0 || box_rows > 256
        || box_cols > 256 || (box_cols * elem) % 16 != 0)
        return cudaErrorInvalidValue;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * elem};
    const cuuint32_t box[2] = {box_cols, box_rows};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                          box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D map of a row-major (d2, d1, d0) array of elem-byte elements, read in
// 128-byte-swizzled boxes of box_rows indices of d2 x one index of d1 x 128
// bytes of d0: one head's rows of a (rows, heads, head_dim) array, laid out
// in shared memory as a 2-D box of box_rows rows would be. TMA zero-fills
// what lies past the array; base and row strides as for make_map.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* base,
                               CUtensorMapDataType type, int elem, uint64_t d2,
                               uint64_t d1, uint64_t d0, uint32_t box_rows)
{
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr)
        return cudaErrorNotSupported;
    if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || (d0 * elem) % 16 != 0
        || d0 * elem < 128 || d0 == 0 || d1 == 0 || d2 == 0 || box_rows == 0
        || box_rows > 256)
        return cudaErrorInvalidValue;
    const cuuint64_t dims[3] = {d0, d1, d2};
    const cuuint64_t strides[2] = {d0 * elem, d0 * d1 * elem};
    const cuuint32_t box[3] = {128u / elem, 1, box_rows};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides,
                          box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device: mbarriers and TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte-aligned byte of dynamic shared memory (the 128B
// swizzle repeats every 1024 bytes), as an offset from the array, so the
// compiler keeps the shared address space and emits shared-memory accesses.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* smem)
{
    const uint32_t a = smem_addr(smem);
    return smem + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes barrier initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init()
{
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// makes generic-proxy writes to shared memory visible to the async proxy
// (wgmma, TMA stores)
__device__ __forceinline__ void fence_proxy_async()
{
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    const uint32_t a = smem_addr(bar);
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(a), "r"(parity) : "memory");
    } while (!done);
}

// box (c0 = column, c1 = row) of the map into shared memory at dst (1024-byte
// aligned for the 128B swizzle), completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_addr(bar)), "r"(c0), "r"(c1) : "memory");
}

// box (c0 = column, c1 = middle index, c2 = row) of a 3-D map into shared
// memory at dst, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2)
{
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------
// Shared-memory matrix descriptor of a 128B-swizzled operand: start address,
// leading and stride byte offsets (in bytes here, stored in 16-byte units),
// base offset 0 (every stage is 1024-byte aligned), swizzle mode 1 (128B).
//  * K-major (rows of 128 bytes along K): SBO = 1024, the step between
//    8-row groups; LBO is unused; the next k step adds 32 bytes to start.
//  * MN-major (rows of 128 bytes = 64 bf16 along M or N, one row per k):
//    SBO = 1024, the step between groups of 8 k; LBO = the step between
//    64-wide column blocks; the next k16 step adds 16 rows = 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo)
{
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
        | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
        | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
        | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a
// wgmma fence, commit or wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// m64n256k16: d (64 x 256, fp32) += A (64 x 16, bf16) * B (16 x 256, bf16),
// operands in shared memory by descriptor; TA / TB = 1: that operand is
// MN-major. The accumulator fragment (any N): thread t of the warpgroup
// holds, for j < N/8, d[4j + 2h + e] = D[16 (t / 32) + (t % 32) / 4 + 8h]
// [8j + 2 (t % 4) + e], h and e in {0, 1}.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// m64n64k16: the same with a 64-wide B (the attention kernels' scores).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// m64nNk16 with A from registers, N = 8 .. 256 (d holds N / 2 floats): d
// (64 x N, fp32) += A (64 x 16, bf16) * B (16 x N, bf16, in shared memory
// by descriptor; TB = 1: MN-major). The A fragment of thread t of the
// warpgroup (warp w = t / 32, g = (t % 32) / 4, q = t % 4), each register a
// bf16 pair, the lower column in the low half: a[0] = A[16w + g][2q, 2q+1],
// a[1] = A[16w + g + 8][2q, 2q+1], a[2] and a[3] the same rows at columns
// 2q+8, 2q+9. That is the accumulator fragment above, read as pairs: the
// fp32 accumulators of an m64nKk16 product over columns 16s .. 16s+15,
// d[8s .. 8s+7] rounded pairwise to bf16, are the A fragment of k16 step s
// of the next product -- how attention feeds P = softmax(S) to P V.
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// m64nNk32, N = 64, 128, 256: d (64 x N, int32) += A (64 x 32, int8) *
// B (32 x N, int8), both operands K-major (8-bit wgmma takes no transpose);
// the same fragment as above.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
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

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// the kernel skeleton
// ---------------------------------------------------------------------------
template <class P>
constexpr size_t smem_bytes()
{
    return 1024 + P::STAGES * (P::A_BYTES + P::B_BYTES) + 2 * P::STAGES * 8;
}

template <class P>
__global__ void __launch_bounds__(threads<P>(), P::BLOCKS)
ring_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb, const typename P::Args args)
{
    extern __shared__ uint8_t smem_raw[];
    uint8_t* a_ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* b_ring = a_ring + P::STAGES * P::A_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(b_ring + P::STAGES * P::B_BYTES);
    uint64_t* empty = full + P::STAGES;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * P::BN;
    const int kt_n = P::k_tiles(args);

    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < P::STAGES; ++s) {
            mbar_init(&full[s], 1);            // the producer's arrive + bytes
            mbar_init(&empty[s], 2);           // one arrive per consumer
        }
        fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;          // 0, 1: consumers; 2: producer
    if (wg == 2) {
        if constexpr (P::BLOCKS == 1)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
        if (threadIdx.x == 256) {
            for (int kt = 0; kt < kt_n; ++kt) {
                const int s = kt % P::STAGES;
                if (kt >= P::STAGES)
                    mbar_wait(&empty[s], ((kt / P::STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(&full[s], P::A_BYTES + P::B_BYTES);
                P::load(a_ring + s * P::A_BYTES, b_ring + s * P::B_BYTES, &ta,
                        &tb, &full[s], kt, m0, n0);
            }
        }
    } else {
        if constexpr (P::BLOCKS == 1)
            asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
        const int t = threadIdx.x % 128;
        typename P::Acc acc;
#pragma unroll
        for (int i = 0; i < int(sizeof(acc) / sizeof(acc[0])); ++i) acc[i] = 0;
        for (int kt = 0; kt < kt_n; ++kt) {
            const int s = kt % P::STAGES;
            mbar_wait(&full[s], (kt / P::STAGES) & 1);
            fence_acc(acc);
            wgmma_fence();
            P::mma(acc, smem_addr(a_ring + s * P::A_BYTES) + wg * P::A_WG,
                   smem_addr(b_ring + s * P::B_BYTES));
            wgmma_commit();
            fence_acc(acc);
            wgmma_wait<1>();                   // tile kt - 1's group is done
            if (kt > 0 && t == 0)
                mbar_arrive(&empty[(kt - 1) % P::STAGES]);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        P::store(acc, args, m0 + 64 * wg, n0, t);
    }
}

// Launches ring_kernel<P> on a grid of (N tiles, M tiles); returns
// cudaGetLastError() after the launch.
template <class P>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const typename P::Args& args, int M, int N, cudaStream_t s)
{
    constexpr size_t smem = smem_bytes<P>();
    // an SM has 233,472 bytes of shared memory, 1 KB of it reserved a block
    static_assert((smem + 1024) * P::BLOCKS <= 233472,
                  "the ring does not fit in shared memory");
    const cudaError_t e = cudaFuncSetAttribute(
        ring_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess)
        return e;
    const dim3 grid((N + P::BN - 1) / P::BN, (M + BM - 1) / BM);
    ring_kernel<P><<<grid, threads<P>(), smem, s>>>(ta, tb, args);
    return cudaGetLastError();
}

}  // namespace hopper
