// Shared by the S-lane block sweeps cavi_block_sweep_s (cavi_s.cu) and
// cavi_block_sweep_mix_s (cavi_mix.cu): one CTA of 4 T / E threads per
// (lane tile of L = 4 LT lanes, LD block), thread (warp w, tx, ly) owning
// lanes LT ly .. LT ly + LT - 1 and the E coordinates 8 E w + E tx .. + E - 1
// of a (T, T) diagonal tile (E = 4: 128 threads, 32 coordinates a warp;
// E = 2: 256 threads, 16 a warp). Here: the lane vector's layout and its
// loads and stores, the cp.async helpers (also coupling_pass_s's and
// cavi_block_sweep_mix_s1's), the register-tiled (T, T) product, the
// staging of a block's diag_nz flags (also cavi_block_sweep_mix_s1's) and
// of the chunks' first writes, and the rank-T update over the nonzero
// 32 x 32 blocks.
//
// The pieces that read the LD tiles take their element type (Tile, E in
// s1_tile.cuh): int8_t (the quantized LD, values scaled by BlockLD.scale
// after each sum) or float (float32 LD, scale 1). The lane sweeps keep the
// (T, T) diagonal tile as floats in shared memory either way: an int8 tile
// is dequantized into it by load_tile, a float tile copied by
// stage_tile_f32 (cp.async, 16 bytes a copy, the next tile's copy issued
// before the rank-T update of this one).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_tile.cuh"

namespace {

// E is the int8 tile element (else float32).
template <class E>
constexpr bool kInt8 = std::is_same_v<E, int8_t>;
// A tile element as a kernel holds it before its conversion: an int8 value
// widened to int, or the float itself.
template <class E>
using TileWord = std::conditional_t<kInt8<E>, int, float>;
// A tile element as an exact float: i8_to_f32 for an int8 value, the
// identity for a float.
__device__ __forceinline__ float to_f32(int b) { return i8_to_f32(b); }
__device__ __forceinline__ float to_f32(float x) { return x; }
// Four consecutive tile elements as a kernel loads them (one int of four
// int8 values, or a float4), and as exact floats.
template <class E>
using TileWord4 = std::conditional_t<kInt8<E>, int, float4>;
__device__ __forceinline__ float4 to_f32x4(int w) { return i8x4_to_f32(w); }
__device__ __forceinline__ float4 to_f32x4(float4 v) { return v; }

constexpr int T = 128;           // tile width: coordinates updated jointly
constexpr int NZ = 32;           // side of the blocks BlockLD.diag_nz flags

// threads of a sweep CTA whose threads own E coordinates of a tile each
__host__ __device__ constexpr int sweep_threads(int E) { return 4 * T / E; }
constexpr int SWEEP_THREADS = sweep_threads(4);   // 4 warps

__device__ __forceinline__ size_t lane_off(int s, int b, int NB, int B) {
    return (static_cast<size_t>(s) * NB + b) * B;
}

// A lane group's stride in the (T, RS) lane vector: float, float2, float4
// or float4 + float; RS pads the rows against bank conflicts of the stores.
__host__ __device__ constexpr int lane_stride(int LT) {
    return LT == 5 ? 8 : LT;
}
__host__ __device__ constexpr int row_stride(int LT) {
    return 4 * lane_stride(LT) + 4;
}

template <int LT>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[LT]) {
    if constexpr (LT == 1) {
        v[0] = p[0];
    } else if constexpr (LT == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        v[0] = x.x; v[1] = x.y;
    } else {
        static_assert(LT == 4 || LT == 5, "lane tiles of 1, 2, 4 or 5 lanes");
        const float4 x = *reinterpret_cast<const float4*>(p);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        if constexpr (LT == 5) v[4] = p[4];
    }
}

template <int LT>
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[LT]) {
    if constexpr (LT == 1) {
        p[0] = v[0];
    } else if constexpr (LT == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        if constexpr (LT == 5) p[4] = v[4];
    }
}

// Column e of a thread's (LT, E) elements into the lane vector's row j.
template <int LT, int E>
__device__ __forceinline__ void store_column(float* v, int j, int lo,
                                             const float (&x)[LT][E], int e) {
    float col[LT];
#pragma unroll
    for (int i = 0; i < LT; ++i) col[i] = x[i][e];
    store_lanes<LT>(v + j * row_stride(LT) + lo, col);
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// p[0..3], or zeros where !ok (a missing lane)
__device__ __forceinline__ float4 ld4_or0(bool ok, const float* p) {
    return ok ? ld4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float get(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// p[0..E-1] (E = 2 or 4, aligned to 4 E bytes), or zeros where !ok
template <int E>
__device__ __forceinline__ void load_or0(bool ok, const float* p,
                                         float (&v)[E]) {
    static_assert(E == 2 || E == 4, "2 or 4 coordinates a thread");
    if constexpr (E == 4) {
        const float4 x = ld4_or0(ok, p);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
        const float2 x = ok ? *reinterpret_cast<const float2*>(p)
                            : make_float2(0.f, 0.f);
        v[0] = x.x; v[1] = x.y;
    }
}

template <int E>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[E]) {
    if constexpr (E == 4)
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// cp.async of 16 bytes (zero-filled where !full), its commit and wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The (T, T) diagonal tile at (t0, t0) of the block's int8 tiles D as exact
// floats in R_s, by the CTA's NT threads.
template <int NT>
__device__ __forceinline__ void load_tile(const int8_t* D, int B, int t0,
                                          float* R_s, int tid) {
    for (int i = tid; i < T * T / 4; i += NT) {
        const int r = i / (T / 4), c4 = i % (T / 4);
        reinterpret_cast<float4*>(R_s)[i] = i8x4_to_f32(
            *reinterpret_cast<const int*>(
                D + static_cast<size_t>(t0 + r) * B + t0 + 4 * c4));
    }
}

// The (T, T) diagonal tile at (t0, t0) of the block's float tiles D into R_s
// by cp.async, 16 bytes a copy, by the CTA's NT threads, and the commit of
// their group (the caller waits for it and synchronizes before R_s is read).
template <int NT>
__device__ __forceinline__ void stage_tile_f32(const float* D, int B, int t0,
                                               float* R_s, int tid) {
    for (int i = tid; i < T * T / 4; i += NT) {
        const int r = i / (T / 4), c4 = i % (T / 4);
        cp_async16(R_s + 4 * i,
                   D + static_cast<size_t>(t0 + r) * B + t0 + 4 * c4, true);
    }
    cp_async_commit();
}

// acc[i][e] = sum over k = 0..T-1, ascending, of v[k][lane i] R[k][j + e]
// (|R| where ABS): one fmaf chain per element. Per k one float4 (E = 4) or
// float2 (E = 2) of R's row and LT lane values feed E LT FMA.
template <int LT, int E, bool ABS>
__device__ __forceinline__ void tile_product(float (&acc)[LT][E],
                                             const float* R, const float* v,
                                             int j, int lo) {
    constexpr int RS = row_stride(LT);
#pragma unroll
    for (int i = 0; i < LT; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = 0.0f;
    // unrolled by 16 so that the loads run ahead of their FFMA: chip_smoke.py
    // read a sweep at S = 100 at 20.3 ms, against 21.4 ms unrolled by 4
    // (H100 80GB HBM3, 700 W; PERF.md)
#pragma unroll 16
    for (int k = 0; k < T; ++k) {
        float r[E];
        if constexpr (E == 4) {
            const float4 x = ld4(R + k * T + j);
            r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
        } else {
            const float2 x = *reinterpret_cast<const float2*>(R + k * T + j);
            r[0] = x.x; r[1] = x.y;
        }
        if (ABS) {
#pragma unroll
            for (int e = 0; e < E; ++e) r[e] = fabsf(r[e]);
        }
        float x[LT];
        load_lanes<LT>(v + k * RS + lo, x);
#pragma unroll
        for (int i = 0; i < LT; ++i)
#pragma unroll
            for (int e = 0; e < E; ++e)
                acc[i][e] = fmaf(x[i], r[e], acc[i][e]);
    }
}

// Block b's diag_nz flags, (B/32, B/32), into nz, by the CTA's NT threads.
template <int NT>
__device__ __forceinline__ void stage_flags(const uint8_t* diag_nz, int b,
                                            int nb32, unsigned char* nz,
                                            int tid) {
    const int* src = reinterpret_cast<const int*>(
        diag_nz + static_cast<size_t>(b) * nb32 * nb32);
    for (int i = tid; i < nb32 * nb32 / 4; i += NT)
        reinterpret_cast<int*>(nz)[i] = src[i];
}

// Into first_s, for each 32-column chunk of the block, the first tile whose
// rank-T update writes it: the first whose rows hold a nonzero there, at the
// latest its own tile. Until then the chunk's q is q_in's (the kernels
// update q in place in q_out). The caller synchronizes between stage_flags
// and this (it reads nz).
template <int NT>
__device__ __forceinline__ void stage_first_writes(const unsigned char* nz,
                                                   int nb32, int* first_s,
                                                   int tid) {
    for (int cc = tid; cc < nb32; cc += NT) {
        int first = cc / (T / NZ);
        for (int t1 = 0; t1 < first; ++t1) {
            bool hit = false;
            for (int r = 0; r < T / NZ; ++r)
                hit |= nz[(t1 * (T / NZ) + r) * nb32 + cc] != 0;
            if (hit) first = t1;
        }
        first_s[cc] = first;
    }
}

// The rows of the tile in which some lane moved into rows_s (bit k of the
// 128-bit words: row k): a thread's `moved` has bit e set where some lane's
// change at its coordinate jt + e is nonzero, and warp w's 8 E rows are the
// bits 8 E w .. of rows_s. The caller synchronizes before the words are
// read.
template <int E>
__device__ __forceinline__ void publish_rows(unsigned moved, int tx, int w,
                                             int tid, unsigned* rows_s) {
    moved |= __shfl_xor_sync(0xffffffffu, moved, 8);
    moved |= __shfl_xor_sync(0xffffffffu, moved, 16);
    moved <<= E * tx;
    moved |= __shfl_xor_sync(0xffffffffu, moved, 1);
    moved |= __shfl_xor_sync(0xffffffffu, moved, 2);
    moved |= __shfl_xor_sync(0xffffffffu, moved, 4);
    if (tid % 32 == 0) {
        if constexpr (E == 4)
            rows_s[w] = moved;
        else   // two warps to a word: the half of it for the warp's 16 rows
            reinterpret_cast<uint16_t*>(rows_s)[w] =
                static_cast<uint16_t>(moved);
    }
}

// The rank-T update of the tile at t0 for the thread's LT lanes:
// q[l, :] += scale * d[l, :] R[tile rows, :] over the nonzero 32 x 32 blocks
// of the tile's 128 rows (R symmetric), then q -= d at the tile's own
// coordinates (the stored unit diagonal also moved q there). vc holds every
// lane's d (the (T, RS) lane vector) and rows_s the rows in which some lane
// moved; groups of 8 rows where none did are skipped. Chunk n of 32
// columns goes to warp n % NW of the CTA's NW warps, whose thread (tx, ly)
// takes 4 of its columns; the tile's own four chunks are always visited.
// Each accumulator is one fmaf chain over the rows in ascending order;
// skipped blocks and rows add exact zeros (for finite d). R's rows come from
// the block's tiles D in global memory, 4 consecutive elements a load (an
// int of int8 values, or a float4), 8 rows of a group in flight.
template <int LT, int NW, class Tile>
__device__ __forceinline__ void rank_t_update(
    const Tile* D, int B, int t0, const unsigned char* nz,
    const unsigned* rows_s, const int* first_s, const float* vc,
    const float* q_in, float* q_out, const size_t (&lane_base)[LT],
    const bool (&valid)[LT], float scale, int tx, int w, int lo, int tid) {
    constexpr int RS = row_stride(LT);
    const int nb32 = B / NZ;
    const int rb0 = t0 / NZ;   // the tile's first row block
    int n = 0;
    for (int cw = 0; cw < nb32; cw += 32) {
        const int cx = cw + tid % 32;
        bool hit = cx >= rb0 && cx < rb0 + T / NZ;   // unit diagonal
        if (cx < nb32) {
#pragma unroll
            for (int r = 0; r < T / NZ; ++r)
                hit |= nz[(rb0 + r) * nb32 + cx] != 0;
        } else {
            hit = false;
        }
        unsigned chunks = __ballot_sync(0xffffffffu, hit);
        for (; chunks; chunks &= chunks - 1, ++n) {
            if (n % NW != w) continue;
            const int cc = cw + __ffs(chunks) - 1;
            const int c = NZ * cc + 4 * tx;   // the thread's 4 columns
            float a[LT][4];
#pragma unroll
            for (int i = 0; i < LT; ++i)
                a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.0f;
            for (int r = 0; r < T / NZ; ++r) {
                if (!nz[(rb0 + r) * nb32 + cc]) continue;
                const unsigned rw = rows_s[r];
                for (int k8 = 0; k8 < NZ; k8 += 8) {
                    if (!((rw >> k8) & 0xffu)) continue;
                    const int k0 = NZ * r + k8;   // row in the tile
                    TileWord4<Tile> raw[8];
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        raw[j] = __ldg(reinterpret_cast<const TileWord4<Tile>*>(
                            D + static_cast<size_t>(t0 + k0 + j) * B + c));
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const float4 rv = to_f32x4(raw[j]);
                        float x[LT];
                        load_lanes<LT>(vc + (k0 + j) * RS + lo, x);
#pragma unroll
                        for (int i = 0; i < LT; ++i) {
                            a[i][0] = fmaf(x[i], rv.x, a[i][0]);
                            a[i][1] = fmaf(x[i], rv.y, a[i][1]);
                            a[i][2] = fmaf(x[i], rv.z, a[i][2]);
                            a[i][3] = fmaf(x[i], rv.w, a[i][3]);
                        }
                    }
                }
            }
            const bool focal = c >= t0 && c < t0 + T;
            const float* q_now = first_s[cc] < t0 / T ? q_out : q_in;
#pragma unroll
            for (int i = 0; i < LT; ++i) {
                if (!valid[i]) continue;
                float4 q = ld4(q_now + lane_base[i] + c);
                q.x += a[i][0] * scale;
                q.y += a[i][1] * scale;
                q.z += a[i][2] * scale;
                q.w += a[i][3] * scale;
                if (focal) {
                    // the stored unit diagonal also moved q at the focal
                    // variants
                    const float* dv = vc + (c - t0) * RS + lo + i;
                    q.x -= dv[0];
                    q.y -= dv[RS];
                    q.z -= dv[2 * RS];
                    q.w -= dv[3 * RS];
                }
                *reinterpret_cast<float4*>(q_out + lane_base[i] + c) = q;
            }
        }
    }
}

}  // namespace
