// The tensor-core (wgmma) body shared by the two prefill-attention kernels
// for Hopper (sm_90a): csrc/flash_attention.cu (the cold prefill) and
// csrc/paged_prefix_attention.cu (the prefix-cache tail prefill). Both
// compute causal, GQA, softcapped online-softmax attention over (query tile
// x key tile) for bf16 operands; they differ only in where a key tile comes
// from, and each brings its own producer.
//
// The function, per score: s = dot(q, k) (bf16 operands, fp32 sum) * scale;
// the tanh softcap c * tanh(s / c); -1e30 where masked; an online softmax
// with fp32 m and l; p = exp(s - m), summed into l in fp32 and rounded to
// bf16 for the value product; out = acc / max(l, 1e-30), a correctly
// rounded division. This is the reference model's prefill attention
// (src/repro/models/attention.py::flash_attention and flash_attention_abs:
// scale after the dot, p cast to v's dtype before P V). The per-score work
// runs on the multi-function unit, not the library's tanhf and expf:
//  * tanh(t) = (1 - e) / (1 + e) * sign(t), e = 2^(-2 |t| log2 e) (ex2 and
//    rcp approximations, relative errors near 2^-22 and 2^-23): the capped
//    logit is within c * 2^-21 of c * tanh(t) (2.4e-5 at c = 50), where
//    tanh.approx (relative error near 2^-11) would move a logit near |s| =
//    40 by ~0.02;
//  * p = 2^((s - m) log2 e) and corr = 2^((m - m_new) log2 e): p within
//    about 2^-16 of exp(s - m), relative, for |s - m| < 100 (the roundings
//    of s - m and of the product; smaller p weigh nothing), so a p next to
//    a bf16 rounding boundary may round the other way -- what the
//    tolerance of one bf16 rounding of each p already allows;
//  * the mask is formed only on tiles that hold a masked key for some row
//    of the warpgroup (the diagonal, the window's edge, the last keys).
//
// A block is two consumer warpgroups of 64 query rows (BQ = 128) and a
// producer warpgroup (THREADS = 384), one block an SM. setmaxnreg moves
// registers from the producer (56 a thread) to the consumers (224): the
// output accumulator takes HD / 2 of them (128 at head_dim 256), the scores
// 32, their bf16 fragments 16. ptxas allocates each region to its
// setmaxnreg count (it reports the launch's 168 and no spills); a block of
// 288 threads without setmaxnreg is capped at 168 registers a thread and
// spills at head_dim 256.
//
// A block's query rows are rows of a KV head's query slab: the n_rep query
// heads that read KV head g lie one after another in q, so rows [g * n_rep
// * S, (g + 1) * n_rep * S) are one (n_rep * S, HD) matrix whose row i is
// position i % S of query head g * n_rep + i / S. A block takes 128 of
// them, so the n_rep heads of a group share every K/V tile a block loads,
// and a short sequence (S < 128) still fills the block's rows.
//
// Shared memory (1024-byte aligned): the block's Q tile (two warpgroups x
// HD / 64 boxes of 64 rows x 64 columns, 128-byte swizzled) and a ring of
// STAGES stages, each a K tile then a V tile of BK = 64 key rows in the same
// boxes; barriers full[s] (the producer's arrival and TMA bytes), empty[s]
// (one arrival a consumer warpgroup), and one for Q. 197,672 bytes at head
// dim 256 (two stages).
//
// A consumer warpgroup, for each key tile the block loads:
//  * S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//    HD / 16 steps; scores into 32 fp32 registers a thread;
//  * per score in the accumulator's own layout (hopper_gemm.cuh: thread t
//    holds rows 16 (t / 32) + (t % 32) / 4 and +8, columns 8j + 2 (t % 4) +
//    {0, 1}): scale, softcap, mask; each row's max over its four threads by
//    two shuffles; corr = exp(m - m_new) rescales O and l;
//  * O += P V: the scores' registers, rounded pairwise to bf16, are the A
//    fragments of wgmma m64n{HD}k16 (A from registers); V is the MN-major B
//    operand straight from its TMA boxes;
//  * a tile wholly masked for the warpgroup's rows is skipped (its weights
//    would be exactly 0 once a row has met a valid key, which every causal
//    row has: its own position); the block loads only the tiles live for
//    some row of the block (the TPU kernel's block skip).
// -1e30, never -inf, marks a masked score: a row whose first live tile is
// all masked adds exp(0) = 1 weights of finite rows, wiped by corr =
// exp(-1e30 - m) = 0 at its first valid key.
#pragma once

#include <cuda_bf16.h>

#include "hopper_gemm.cuh"

namespace attn {

// kernels/paged_attention.py reads BQ and BK from this text to plan a
// traced launch, where no library is built; the libraries report them
// (export_tiles) for a launch.
constexpr int BQ = 128;                  // query rows a block: 2 x 64
constexpr int BK = 64;                   // key rows a tile
constexpr int THREADS = 384;             // two consumer warpgroups + a producer one
constexpr int PRODUCER_REGS = 56;        // 128 x 56 + 256 x 224 <= 65,536
constexpr int CONSUMER_REGS = 224;
constexpr uint32_t BOX = 64 * 128;       // 64 rows x 64 bf16 columns
constexpr float NEG = -1e30f;

template <int HD>
struct Ring {
    static constexpr uint32_t Q_WG = (HD / 64) * BOX;   // one warpgroup's 64 rows
    static constexpr uint32_t TILE = (HD / 64) * BOX;   // 64 key or value rows
    static constexpr uint32_t STAGE = 2 * TILE;         // K, then V
    static constexpr int STAGES = HD == 256 ? 2 : 4;
    static constexpr size_t SMEM = 1024 + 2 * Q_WG + STAGES * STAGE
                                   + (2 * STAGES + 1) * 8;
    static_assert(SMEM + 1024 <= 233472, "the ring does not fit in shared memory");
};

// The tiles, which the host's key-window split and reports read: out[0]
// query rows a block, out[1] key rows a tile, then for head dims 64, 128 and
// 256 the head dim, ring stages and dynamic shared bytes (out holds 2 + 3 * 3
// ints). Returns the number of head dims.
inline int export_tiles(int* out)
{
    out[0] = BQ;
    out[1] = BK;
    const int hd[3] = {64, 128, 256};
    const int stages[3] = {Ring<64>::STAGES, Ring<128>::STAGES, Ring<256>::STAGES};
    const int smem[3] = {(int)Ring<64>::SMEM, (int)Ring<128>::SMEM, (int)Ring<256>::SMEM};
    for (int i = 0; i < 3; ++i) {
        out[2 + 3 * i] = hd[i];
        out[3 + 3 * i] = stages[i];
        out[4 + 3 * i] = smem[i];
    }
    return 3;
}

// The register split, executed by every thread of a warpgroup.
__device__ __forceinline__ void producer_regs()
{
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
}

__device__ __forceinline__ void consumer_regs()
{
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
}

// A key tile: key c (0 .. 63) sits at position kpos0 + c and is valid for
// c < nvalid.
struct Tile {
    int kpos0, nvalid;
};

// Whether some key of the tile is unmasked for some query at a position in
// [qlo, qhi] (empty when qhi < qlo).
__device__ __forceinline__ bool live(Tile k, int qlo, int qhi, bool causal,
                                     int window)
{
    if (k.nvalid <= 0 || qhi < qlo)
        return false;
    if (causal && k.kpos0 > qhi)
        return false;
    const int klast = k.kpos0 + min(BK, k.nvalid) - 1;
    return window <= 0 || klast > qlo - window;
}

// Calls f(kt) for each key tile kt of [0, nk) live for positions [qlo,
// qhi] that falls in share z of nsplit contiguous shares of those tiles,
// in order: a block's producer and consumers walk the same tiles.
template <class TileOf, class F>
__device__ __forceinline__ void for_tiles(int nk, const TileOf& tile, int qlo, int qhi,
                                          bool causal, int window, int z, int nsplit,
                                          F&& f)
{
    int n = 0;
    if (nsplit > 1)
        for (int kt = 0; kt < nk; ++kt)
            n += live(tile(kt), qlo, qhi, causal, window);
    const int lo = z * n / nsplit, hi = nsplit > 1 ? (z + 1) * n / nsplit : nk;
    for (int kt = 0, li = 0; kt < nk; ++kt) {
        if (!live(tile(kt), qlo, qhi, causal, window))
            continue;
        if (li >= lo && li < hi)
            f(kt);
        ++li;
    }
}

// The positions of slab rows [lo, hi] (row i is position i % S) as [qlo,
// qhi], widened to [0, S - 1] when the rows span two heads; empty when hi <
// lo.
__device__ __forceinline__ void span(int lo, int hi, int S, int& qlo, int& qhi)
{
    if (hi < lo) {
        qlo = 1;
        qhi = 0;
    } else if (lo / S == hi / S) {
        qlo = lo % S;
        qhi = hi % S;
    } else {
        qlo = 0;
        qhi = S - 1;
    }
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float rcp(float x)
{
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// c * tanh(t) from one exp2 and one reciprocal (error above)
__device__ __forceinline__ float capped(float t, float c)
{
    const float e = ex2(fabsf(t) * (-2.f * LOG2E));
    return copysignf(c * ((1.f - e) * rcp(1.f + e)), t);
}

// Whether every key of the tile is valid for every query at a position in
// [qlo, qhi]: no mask needed.
__device__ __forceinline__ bool full(Tile k, int qlo, int qhi, bool causal,
                                     int window)
{
    return k.nvalid >= BK && (!causal || k.kpos0 + BK - 1 <= qlo)
        && (window <= 0 || qhi - k.kpos0 < window);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi)
{
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}

// The running state of a consumer thread's two rows (r0 and r0 + 8).
template <int HD>
struct Rows {
    float o[HD / 2];     // O fragment: o[4j + 2h + e] = O[r0 + 8h][8j + 2q + e]
    float m[2], l[2];    // running max (the same on a row's four threads) and
                         // this thread's share of the row's sum
    int qpos[2];         // the rows' positions

    __device__ __forceinline__ void init()
    {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
        m[0] = m[1] = NEG;
        l[0] = l[1] = 0.f;
    }

    // One key tile: q_addr the warpgroup's Q boxes, k_addr / v_addr the
    // stage's K and V tiles (shared-space addresses), q = t % 4; MASK:
    // whether some key of the tile is masked for some row of the
    // warpgroup. sc = scale / softcap with a softcap, else scale.
    template <bool MASK>
    __device__ __forceinline__ void attend(uint32_t q_addr, uint32_t k_addr,
                                           uint32_t v_addr, Tile tile, int q,
                                           bool causal, int window, float sc,
                                           float softcap)
    {
        float s[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
        const uint64_t qd = hopper::desc_sw128(q_addr, 16, 1024);
        const uint64_t kd = hopper::desc_sw128(k_addr, 16, 1024);
        hopper::fence_acc(s);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
            // the start address field, in 16-byte units, stays below 2^14
            const uint32_t off = ((ks / 4) * BOX + 32 * (ks % 4)) >> 4;
            hopper::wgmma_bf16<0, 0>(s, qd + off, kd + off);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(s);

        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float x = s[4 * j + 2 * h + e] * sc;
                    if (softcap > 0.f)
                        x = capped(x, softcap);
                    if constexpr (MASK) {
                        const int c = 8 * j + 2 * q + e, kpos = tile.kpos0 + c;
                        bool valid = c < tile.nvalid;
                        if (causal)
                            valid = valid && kpos <= qpos[h];
                        if (window > 0)
                            valid = valid && qpos[h] - kpos < window;
                        x = valid ? x : NEG;
                    }
                    s[4 * j + 2 * h + e] = x;
                    mx[h] = fmaxf(mx[h], x);
                }
        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            // (m - m_new), never a difference of two products: -1e30 - -1e30
            // is exactly 0
            corr[h] = ex2((m[h] - mx[h]) * LOG2E);
            m[h] = mx[h];
        }
        float ls[2] = {0.f, 0.f};
        uint32_t a[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float p0 = ex2((s[4 * j + 2 * h] - m[h]) * LOG2E);
                const float p1 = ex2((s[4 * j + 2 * h + 1] - m[h]) * LOG2E);
                ls[h] += p0 + p1;
                // column pair 8j + 2q of row h: k16 step j / 2, register
                // 2 (j % 2) + h
                a[j / 2][2 * (j % 2) + h] = bf16_pair(p0, p1);
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                o[4 * j + 2 * h] *= corr[h];
                o[4 * j + 2 * h + 1] *= corr[h];
            }

        const uint64_t vd = hopper::desc_sw128(v_addr, BOX, 1024);
        hopper::fence_acc(o);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            hopper::wgmma_rs<1>(o, a[kk], vd + ((2048 * kk) >> 4));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(o);
    }

    // The tile if it is live for the warpgroup's positions [qlo, qhi],
    // masked only where it must be.
    __device__ __forceinline__ void step(uint32_t q_addr, uint32_t k_addr,
                                         uint32_t v_addr, Tile tile, int qlo,
                                         int qhi, int q, bool causal, int window,
                                         float sc, float softcap)
    {
        if (!live(tile, qlo, qhi, causal, window))
            return;
        if (full(tile, qlo, qhi, causal, window))
            attend<false>(q_addr, k_addr, v_addr, tile, q, causal, window, sc,
                          softcap);
        else
            attend<true>(q_addr, k_addr, v_addr, tile, q, causal, window, sc,
                         softcap);
    }

    // each row's sum over its four threads
    __device__ __forceinline__ void sum_l()
    {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
            l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        }
    }

    // A share of the key window's unnormalised rows: acc to o_row[h] (HD
    // floats), (m, l) to ml_row[h]; null for a row not stored.
    __device__ __forceinline__ void store_partial(float* (&o_row)[2],
                                                  float* (&ml_row)[2], int q)
    {
        sum_l();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (o_row[h] == nullptr)
                continue;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                *reinterpret_cast<float2*>(o_row[h] + 8 * j + 2 * q) =
                    make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
            if (q == 0)
                *reinterpret_cast<float2*>(ml_row[h]) = make_float2(m[h], l[h]);
        }
    }

    // out = acc / max(l, 1e-30) for the rows given a destination (row_out[h]
    // points at the row's HD elements, or is null for a row not stored).
    template <typename T>
    __device__ __forceinline__ void store(T* (&row_out)[2], int q)
    {
        sum_l();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            T* dst = row_out[h];
            if (dst == nullptr)
                continue;
            const float L = fmaxf(l[h], 1e-30f);
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                const float v0 = o[4 * j + 2 * h] / L, v1 = o[4 * j + 2 * h + 1] / L;
                if constexpr (sizeof(T) == 2)
                    *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * q) = bf16_pair(v0, v1);
                else
                    *reinterpret_cast<float2*>(dst + 8 * j + 2 * q) = make_float2(v0, v1);
            }
        }
    }
};

}  // namespace attn
