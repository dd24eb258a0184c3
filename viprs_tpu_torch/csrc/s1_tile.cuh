// Shared by the single-model block sweeps cavi_block_sweep_s1 (cavi_s1.cu,
// spike-and-slab) and cavi_block_sweep_mix_s1 (cavi_mix.cu, the mixture):
// one CTA of T threads per LD block, thread j owning coordinate j of every
// (T, T) tile of its block and holding column j of the tile as T floats in
// registers. Here: the staging of the next tile and its per-coordinate
// inputs by cp.async, the walk over the flagged 32 x 32 blocks outside a
// tile, their staging into each warp's slots, the load of a tile column
// into registers, the register-column product, and the rank-T update of
// the columns outside the tile.
//
// Each piece takes the LD tile's element type E: int8_t (the quantized LD,
// values scaled by BlockLD.scale after each sum) or float (float32 LD,
// scale 1). int8 tiles are staged in shared memory (two (T, T) tiles and
// each warp's OUT_SLOTS outer blocks: ~61 KB at B = 1024). Stored as
// float32 the same layout would need ~209 KB, one CTA an SM, so float
// tiles are not staged at all: thread j loads column j of a tile straight
// from global memory into its registers (for each row k a warp reads 32
// consecutive floats, one coalesced 128-byte line), and the rank-T update
// reads every flagged outer block from global memory, as the int8 update
// reads the blocks past its slots.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tile.cuh"

namespace {

// The single-model sweep's CTA: T threads, thread j owning coordinate j of
// every (T, T) tile of its block.
constexpr int S1_THREADS = T;
constexpr int S1_WARPS = S1_THREADS / 32;
// The flagged 32 x 32 blocks outside a tile that a warp stages by cp.async
// for its rank-T update; more are read from global memory when used.
constexpr int OUT_SLOTS = 4;

// Bytes of shared memory both sweeps lay out after their float arrays, in
// this order: for int8 tiles two (T, T) tile buffers and each warp's
// OUT_SLOTS staged 32 x 32 blocks; then the block's diag_nz flags ((B/32)^2
// bytes).
template <class E>
__host__ __device__ constexpr size_t s1_tile_smem(int B) {
    return (kInt8<E> ? 2 * T * T + S1_WARPS * OUT_SLOTS * NZ * NZ : 0)
        + static_cast<size_t>(B / NZ) * (B / NZ);
}

// By cp.async, 16 bytes a copy: for int8 tiles the (T, T) tile at (t0, t0)
// of the block's tiles D into R_dst; the tile's NI per-coordinate inputs
// into in_dst, NI rows of T: row r from src(r) + jt, jt the tile's element
// offset in the (NB, B) planes.
template <int NI, class E, class Src>
__device__ __forceinline__ void stage_tile_async(const E* D, int B, int t0,
                                                 int8_t* R_dst,
                                                 float* in_dst, size_t jt,
                                                 int tid, Src&& src) {
    if constexpr (kInt8<E>) {
#pragma unroll
        for (int s = 0; s < T * T / 16 / S1_THREADS; ++s) {
            const int i = tid + s * S1_THREADS;
            const int r = i / (T / 16), part = i % (T / 16);
            cp_async16(R_dst + r * T + 16 * part,
                       D + static_cast<size_t>(t0 + r) * B + t0 + 16 * part,
                       true);
        }
    }
    for (int i = tid; i < NI * T / 4; i += S1_THREADS) {
        const int row = i / (T / 4), c = 4 * (i % (T / 4));
        cp_async16(in_dst + row * T + c, src(row) + jt + c, true);
    }
}

// Warp w's share of the 32-column chunks outside the tile whose rows
// t0 .. t0 + T - 1 hold a flagged 32 x 32 block: f(cc) for each, chunk n
// of them (ascending) going to warp n % S1_WARPS.
template <class F>
__device__ __forceinline__ void outer_chunks(const unsigned char* nz,
                                             int nb32, int rb0, int lane,
                                             int w, F&& f) {
    int n = 0;
    for (int cw = 0; cw < nb32; cw += 32) {
        const int cx = cw + lane;
        bool hit = false;
        if (cx < nb32 && (cx < rb0 || cx >= rb0 + T / NZ)) {
#pragma unroll
            for (int rb = 0; rb < T / NZ; ++rb)
                hit |= nz[(rb0 + rb) * nb32 + cx] != 0;
        }
        unsigned chunks = __ballot_sync(0xffffffffu, hit);
        for (; chunks; chunks &= chunks - 1, ++n)
            if (n % S1_WARPS == w) f(cw + __ffs(chunks) - 1);
    }
}

// The flagged 32 x 32 blocks outside the tile at t0 (rows t0 .. t0 + T - 1
// of the block's tiles D, row block rb0 = t0 / 32) that warp w updates,
// into its OUT_SLOTS slots my_out by cp.async (the rest are read from
// global memory when used), and the commit of their group. Float tiles
// stage none.
template <class E>
__device__ __forceinline__ void stage_outer_blocks(const E* D, int B, int t0,
                                                   const unsigned char* nz,
                                                   int nb32, int lane, int w,
                                                   int8_t* my_out) {
    if constexpr (kInt8<E>) {
        const int rb0 = t0 / NZ;
        int slot = 0;
        outer_chunks(nz, nb32, rb0, lane, w, [&](int cc) {
            for (int rb = 0; rb < T / NZ; ++rb) {
                if (!nz[(rb0 + rb) * nb32 + cc]) continue;
                if (slot < OUT_SLOTS) {
                    const int8_t* src = D
                        + static_cast<size_t>(t0 + NZ * rb + lane) * B
                        + NZ * cc;
                    int8_t* dst = my_out + (slot * NZ + lane) * NZ;
                    cp_async16(dst, src, true);
                    cp_async16(dst + 16, src + 16, true);
                }
                ++slot;
            }
        });
        cp_async_commit();
    }
}

// Column j of the tile at t0 as T exact floats into r: from the staged
// int8 tile Rt, or (float tiles) from the block's tiles D in global memory.
template <class E>
__device__ __forceinline__ void load_column(float (&r)[T], const int8_t* Rt,
                                            const E* D, int B, int t0,
                                            int j) {
    if constexpr (kInt8<E>) {
#pragma unroll
        for (int k = 0; k < T; ++k) r[k] = i8_to_f32(Rt[k * T + j]);
    } else {
        const float* col = D + static_cast<size_t>(t0) * B + t0 + j;
#pragma unroll
        for (int k = 0; k < T; ++k)
            r[k] = __ldg(col + static_cast<size_t>(k) * B);
    }
}

// R_jj of the tile at t0 as an exact float (before the scale), from the
// staged int8 tile Rt or from global memory.
template <class E>
__device__ __forceinline__ float diag_value(const int8_t* Rt, const E* D,
                                            int B, int t0, int j) {
    if constexpr (kInt8<E>)
        return i8_to_f32(Rt[j * T + j]);
    else
        return __ldg(D + static_cast<size_t>(t0 + j) * B + t0 + j);
}

// acc = sum over k = 0..T-1, ascending, of v[k] r[k] (|r[k]| where ABS):
// one fmaf chain, r from registers, v read four at a time (a broadcast)
// V_AHEAD float4 loads ahead of its use. The compiler barrier after each
// load keeps the loads where they are: hoisted all together they would hold
// 128 more registers and spill.
constexpr int V_AHEAD = 4;
template <bool ABS>
__device__ __forceinline__ float column_product(const float (&r)[T],
                                                const float* v) {
    float4 xs[V_AHEAD];
#pragma unroll
    for (int a = 0; a < V_AHEAD; ++a) xs[a] = ld4(v + 4 * a);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < T; k += 4) {
        const float4 x = xs[(k / 4) % V_AHEAD];
        if (k + 4 * V_AHEAD < T)
            xs[(k / 4) % V_AHEAD] = ld4(v + k + 4 * V_AHEAD);
        asm volatile("" ::: "memory");
        acc = fmaf(x.x, ABS ? fabsf(r[k]) : r[k], acc);
        acc = fmaf(x.y, ABS ? fabsf(r[k + 1]) : r[k + 1], acc);
        acc = fmaf(x.z, ABS ? fabsf(r[k + 2]) : r[k + 2], acc);
        acc = fmaf(x.w, ABS ? fabsf(r[k + 3]) : r[k + 3], acc);
    }
    return acc;
}

// The rank-T update of the block's q in shared memory q_s over the columns
// outside the tile at t0: q_s[col] += scale * sum over the tile's rows k,
// ascending, of vc[k] R[t0 + k][col], a thread per column of warp w's
// chunks, each flagged block's 32 rows from the warp's slot (int8, staged
// by stage_outer_blocks, in the same order) or from global memory (past
// the warp's OUT_SLOTS; every block of a float tile). Blocks left out add
// exact zeros (for finite vc).
template <class E>
__device__ __forceinline__ void outer_rank_t(const E* D, int B, int t0,
                                             const unsigned char* nz,
                                             int nb32, int lane, int w,
                                             const int8_t* my_out,
                                             const float* vc, float* q_s,
                                             float scale) {
    const int rb0 = t0 / NZ;
    int slot = 0;
    outer_chunks(nz, nb32, rb0, lane, w, [&](int cc) {
        const int col = NZ * cc + lane;
        float a = 0.f;
        for (int rb = 0; rb < T / NZ; ++rb) {
            if (!nz[(rb0 + rb) * nb32 + cc]) continue;
            TileWord<E> raw[NZ];
            if (kInt8<E> && slot < OUT_SLOTS) {
                const int8_t* src = my_out + slot * NZ * NZ + lane;
#pragma unroll
                for (int i = 0; i < NZ; ++i) raw[i] = src[i * NZ];
            } else {
                const E* src = D
                    + static_cast<size_t>(t0 + NZ * rb) * B + col;
#pragma unroll
                for (int i = 0; i < NZ; ++i)
                    raw[i] = __ldg(src + static_cast<size_t>(i) * B);
            }
            ++slot;
#pragma unroll
            for (int i = 0; i < NZ; i += 4) {
                const float4 dv = ld4(vc + NZ * rb + i);
                a = fmaf(dv.x, to_f32(raw[i]), a);
                a = fmaf(dv.y, to_f32(raw[i + 1]), a);
                a = fmaf(dv.z, to_f32(raw[i + 2]), a);
                a = fmaf(dv.w, to_f32(raw[i + 3]), a);
            }
        }
        q_s[col] += a * scale;
    });
}

}  // namespace
