// Hopper (sm_90a) CUDA kernels for the S-lane (model grid, S > 1) blocked
// CAVI sweep of VIPRS, with a plain C interface for ctypes (ops/_build.py).
//
// cavi_block_sweep_s replaces the TPU kernel _sweep_kernel (the S-lane
// all-active sweep, viprs_tpu/ops/cavi_pallas.py:49) and the sweep part of
// _skip_kernel_s (the S-lane active-block sweep, cavi_pallas.py:1191);
// coupling_pass_s (its note below) applies the coupling tiles after it.
// Their plain PyTorch versions are ops/cavi_torch.block_sweep and
// ops/cavi_torch.coupling_pass.
//
// What bounds it on the card: at S = 100 on the 1.1M-variant genome
// (NB = 1133, B = 1024) one sweep needs 2.37e11 FMA in the inner steps (per
// lane and block, 8 tiles x 8 steps x 2 x 128^2) and 1.19e11 in the rank-T
// updates if every tile were dense (8 x 128 x 1024), 10.6 ms at the H100
// SXM's published 67 TFLOP/s FP32, against 4.2 GB of state traffic (1.25 ms
// at 3.35 TB/s) and a 1.19 GB LD read. So unlike S = 1 the sweep is bound by
// CUDA-core FP32. Banded int8 LD is exactly zero away from the diagonal, so
// most of the rank-T work, and some of the inner steps' (T, T) products,
// multiply zero 32 x 32 blocks; this kernel skips them in the rank-T
// updates only.
//
// Design: one CTA of 128 threads (4 warps) per (lane tile of L = 4 LT lanes,
// LD block); L is 4, 8, 16 or 20 (LT = 1, 2, 4, 5), picked by S
// (cavi_cuda.sweep_lane_tile), so each diagonal tile is dequantized once into
// shared memory as exact floats for up to 20 lanes. Thread (warp w, tx, ly)
// owns lanes LT ly .. LT ly + LT - 1 and the coordinates 32 w + 4 tx .. + 3
// of the tile: LT x 4 elements, whose state it keeps in registers through
// the inner steps and whose two (T, T) products it computes itself,
// register-tiled: per k one float4 of R's row (the warp's 8 of them are one
// shared wavefront) and LT lane values (one wavefront) feed 4 LT FMA. The
// lane vector (the c or d of every lane) is double-buffered in shared
// memory, so an inner step has two barriers. The lanes' hyperparameters sit
// in shared memory, read where used, to keep registers for the state. q
// lives in q_out: the CTA owns (its lanes, block b) and updates it in place,
// reading a 32-column chunk from q_in until the first tile whose rank-T
// update reaches it has written it (so no copy). The rank-T update of a tile
// multiplies only the 32 x 32 blocks of its 128 rows that BlockLD.diag_nz
// flags (the block's flags staged once in shared memory), skipping the
// groups of 8 rows where every lane's change is exactly zero; each warp
// takes every fourth nonzero 32-column chunk, and the tile's own four chunks
// are always visited for the unit-diagonal correction.
//
// Every output element is one fmaf chain over k in ascending order, as in
// the plain loop (no split-K), and skipped blocks and rows add exact zeros
// (for finite eta changes), so a lane's result does not depend on S, its
// lane tile or its place in it, and the skip is bit-identical to the dense
// walk. Frozen lanes and unflagged blocks pass through bit-exactly. No
// atomics; the exact expf/logf/log1pf (no fast math).
//
// Registers and occupancy (nvcc 12.9 -Xptxas -v, sm_90a): 128 / 158 / 253
// / 255 registers a thread for L = 4 / 8 / 16 / 20, the last with 20 bytes
// of spill stores outside the product loops; with 73 / 77 / 86 / 102 KB of
// shared memory (B = 1024) that is 3 / 2 / 2 / 2 CTAs (12 / 8 / 8 / 8
// warps) per SM. In the SASS the products are 4 LT FFMA per k, |R| folded
// into the FFMA as an operand modifier, and 2 or 3 shared loads. Measured
// on an H100 80GB HBM3 at 700 W (PERF.md, PR 6): about 20 ms a sweep at
// S = 100 over the genome's 1133 blocks, half the dense FP32 bound; the
// inner steps take about 16 ms of it, latency-bound at 2 warps per
// scheduler.
//
// coupling_pass_s applies the coupling tiles: per tile o with a flagged end,
// q[:, src_o] += scale U_o diff[:, dst_o] and q[:, dst_o] += scale U_o^T
// diff[:, src_o]. It replaces _off_pass at rows = Sp (cavi_pallas.py:492,
// from _skip_kernel_s :1191 and _mix_skip_kernel_batch :1593) and
// cavi_jax.refresh_q after the all-active kernels. What bounds it: on dense
// tiles a GEMM with M = the lanes, N = a block's coordinates, K = the other
// block's: at S = 100 over the genome's 244 tiles of 1024^2, each applied
// both ways, 5.1e10 FMA = 1.53 ms at 67 TFLOP/s FP32 against 0.26 GB of
// tiles (0.08 ms at 3.35 TB/s), so CUDA-core FP32. But int8 LD that decays
// with distance is mostly exact zeros away from a tile's near corner (99.97%
// of the genome's coupling entries), and there the bound is the state the
// few nonzero blocks touch.
//
// Design: one CTA per (block's slab of CC = 128 output coordinates that some
// tile can change, from BlockLD.cpl_slabs; lane tile of L lanes), so one
// CTA's lanes share every byte of U it reads and a tile is read once per
// orientation for up to L = 100 lanes. The CTA walks the block's incident
// tiles with a flagged end in ascending o and, with the 32 x 32 zero flags
// of BlockLD.off_nz (read once per 32 chunks through a warp ballot), only
// their chunks of KC source coordinates that hold a nonzero in its slab; a
// CTA with none returns at once. Each chunk goes through a 3-stage cp.async
// ring in shared memory (the raw int8 U chunk and the (L, KC) float32 diff
// chunk), two chunks ahead. The int8 chunk is converted once to float32 in a
// (KC, CC) layout, transposed where the block is the tile's source, so both
// orientations feed one inner loop; there each thread keeps LT lanes x 8
// coordinates of FP32 accumulators in registers and loads the W and diff
// values of four k at once (LT + 8 float4 loads feed 32 LT FMA). After the
// tile, q += scale * acc in place, in ascending o, without atomics. Every
// accumulator is one fmaf chain over the tile's k in order, skipped chunks
// adding exact zeros, and the per-tile add is the same fmaf in every
// instance, so a lane's result does not depend on S, its lane tile or its
// place in it; a lane with a zero diff adds +0 and keeps q. q of a slab no
// tile with a flagged end reaches is never touched.
//
// Both kernels are templated on the LD tile's element type Tile: int8_t,
// or float for float32 (dequantized) LD with scale 1; the int8 instances
// are the int8-only kernels' code (same registers, same bits). A float
// (T, T) tile is copied into the same float32 R_s by cp.async
// (lane_tile.cuh stage_tile_f32), the next tile's copy issued once this
// tile's inner steps are done and running under its rank-T update, which
// reads a float4 of R's row where it read four int8 values; the shared
// layout keeps its size. The float coupling pass stages its chunks raw as
// well, 4x the bytes, in a ring of 2 stages beside the diff ring of 3
// (raw_stages), the conversion a copy or a transpose from rows padded to
// KC + 4 floats: 69.7 / 74.8 / 81.5 / 110.2 KiB of shared memory at L = 4
// / 16 / 32 / 100, 3 / 3 / 2 / 2 CTAs an SM. Registers of the float
// instances (nvcc 12.9, sm_90a): sweep 126 / 152 / 248 / 255 at L = 4 / 8
// / 16 / 20 (the last with 24 bytes of spill), coupling 209 / 240 / 168 /
// 96 at L = 4 / 16 / 32 / 100 (the last with 72 bytes of spill; its launch
// bounds cap it at 102).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tile.cuh"

namespace {

constexpr float ETA_DIFF_EPS = 1e-8f;
// the lane hyperparameters a sweep CTA keeps in shared memory, per lane
enum { H_SIG, H_TAU, H_ONE_LAM, H_BASE, H_ACT, H_ON, N_HYP };

__device__ __forceinline__ float sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// One CTA per (lane tile of L = 4 LT lanes, LD block b). State tensors are
// (S, NB, B) float32; hyper is (5, S): [sigma_eps, tau_beta, pi, active,
// lambda_min]; diag_nz is (NB, B/32, B/32) uint8. A block with
// blk_mask[b] == 0, or a tile whose lanes all have active == 0, is copied
// through bit-exactly with a zero eta change. Otherwise, per tile of T
// coordinates: the inner_steps gamma-weighted under-relaxed Jacobi steps of
// every (lane, coordinate) against the (T, T) tile; the keep gate drops
// |d_eta| < 1e-8; the rank-T update q[l, :] += scale * d[l, :] R[tile rows,
// :] over the nonzero 32 x 32 blocks; the unit-diagonal correction. diag
// is (NB, B, B) of Tile: int8 (dequantized into R_s by load_tile) or float
// (copied into R_s by cp.async, the next tile's copy in flight during the
// rank-T update of this one; scale 1).
template <int LT, class Tile>
__global__ void __launch_bounds__(SWEEP_THREADS, 2)
cavi_block_sweep_s(const Tile* __restrict__ diag,
                   const uint8_t* __restrict__ diag_nz,
                   const float* __restrict__ beta,
                   const float* __restrict__ nn,
                   const float* __restrict__ mask,
                   const float* __restrict__ logits_in,
                   const float* __restrict__ mu_in,
                   const float* __restrict__ eta_in,
                   const float* q_in,   // q_in and q_out: no __restrict__,
                   float* __restrict__ logits_out,
                   float* __restrict__ mu_out,
                   float* __restrict__ eta_out,
                   float* q_out,        // both are read through q_now
                   float* __restrict__ eta_diff,
                   const int* __restrict__ blk_mask,
                   const float* __restrict__ hyper,
                   int S, int NB, int B, float scale, int inner_steps) {
    constexpr int L = 4 * LT, LS = lane_stride(LT), RS = row_stride(LT);
    extern __shared__ __align__(16) unsigned char smem[];
    float* R_s = reinterpret_cast<float*>(smem);          // (T, T)
    float* vc = R_s + T * T;                              // (T, RS): c, d_t
    float* vd = vc + T * RS;                              // (T, RS): d
    float* hyp = vd + T * RS;                             // (N_HYP, L)
    unsigned* rows_s = reinterpret_cast<unsigned*>(hyp + N_HYP * L);  // 4
    int* first_s = reinterpret_cast<int*>(rows_s + T / NZ);          // B/32
    // the block's diag_nz, (B/32, B/32)
    unsigned char* nz = reinterpret_cast<unsigned char*>(first_s + B / NZ);

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int s0 = blockIdx.x * L;
    const int nl = min(L, S - s0);

    bool any_on = false;
    for (int l = 0; l < nl; ++l) any_on |= hyper[3 * S + s0 + l] > 0.0f;
    if (!blk_mask[b] || !any_on) {
        for (int l = 0; l < nl; ++l) {
            const size_t off = lane_off(s0 + l, b, NB, B);
            for (int c = 4 * tid; c < B; c += 4 * SWEEP_THREADS) {
                *reinterpret_cast<float4*>(logits_out + off + c) =
                    ld4(logits_in + off + c);
                *reinterpret_cast<float4*>(mu_out + off + c) =
                    ld4(mu_in + off + c);
                *reinterpret_cast<float4*>(eta_out + off + c) =
                    ld4(eta_in + off + c);
                *reinterpret_cast<float4*>(q_out + off + c) =
                    ld4(q_in + off + c);
                *reinterpret_cast<float4*>(eta_diff + off + c) =
                    make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
        return;
    }

    const int w = tid / 32, tx = tid % 8, ly = (tid % 32) / 8;
    const int jt = 32 * w + 4 * tx;   // the thread's coordinates in a tile
    const int lo = ly * LS;           // its lanes' offset in a lane-vector row
    if (tid < L) {
        // missing lanes of the last tile: inert values, never written
        const bool ok = tid < nl;
        const int s = s0 + tid;
        const float tau = ok ? hyper[S + s] : 1.0f;
        const float pi = ok ? hyper[2 * S + s] : 0.5f;
        const float act = ok ? hyper[3 * S + s] : 0.0f;
        hyp[H_SIG * L + tid] = ok ? hyper[s] : 1.0f;
        hyp[H_TAU * L + tid] = tau;
        hyp[H_ONE_LAM * L + tid] = 1.0f + (ok ? hyper[4 * S + s] : 0.0f);
        hyp[H_BASE * L + tid] = logf(pi) - log1pf(-pi) + 0.5f * logf(tau);
        hyp[H_ACT * L + tid] = act;
        hyp[H_ON * L + tid] = act > 0.0f ? 1.0f : 0.0f;
    }
    const Tile* D = diag + static_cast<size_t>(b) * B * B;
    if constexpr (!kInt8<Tile>) stage_tile_f32<SWEEP_THREADS>(D, B, 0, R_s, tid);
    const int nb32 = B / NZ;
    stage_flags<SWEEP_THREADS>(diag_nz, b, nb32, nz, tid);
    __syncthreads();
    // q_out is the block's running q for the CTA's lanes (see
    // stage_first_writes)
    stage_first_writes<SWEEP_THREADS>(nz, nb32, first_s, tid);
    bool valid[LT];
    size_t lane_base[LT];
#pragma unroll
    for (int i = 0; i < LT; ++i) {
        valid[i] = LT * ly + i < nl;
        lane_base[i] = lane_off(s0 + LT * ly + i, b, NB, B);
    }

    for (int t0 = 0; t0 < B; t0 += T) {
        if constexpr (kInt8<Tile>)
            load_tile<SWEEP_THREADS>(D, B, t0, R_s, tid);
        else
            cp_async_wait<0>();
        // R_s loaded; the last tile's q updates and lane-vector reads done
        __syncthreads();

        const size_t jb = static_cast<size_t>(b) * B + t0 + jt;
        const float* q_now = first_s[(t0 + jt) / NZ] < t0 / T ? q_out : q_in;
        const float4 beta4 = ld4(beta + jb), mask4 = ld4(mask + jb);
        float vt[LT][4], mm[LT][4], logvt[LT][4];
        float q_cur[LT][4], g_cur[LT][4], mu_cur[LT][4], eta_cur[LT][4];
        {
            const float4 n4 = ld4(nn + jb);
#pragma unroll
            for (int i = 0; i < LT; ++i) {
                const int l = LT * ly + i;
                const float sig_e = hyp[H_SIG * L + l];
                const float tau_b = hyp[H_TAU * L + l];
                const float one_lam = hyp[H_ONE_LAM * L + l];
                const size_t off = lane_base[i] + t0 + jt;
                const float4 lg = ld4_or0(valid[i], logits_in + off);
                const float4 m0 = ld4_or0(valid[i], mu_in + off);
                const float4 e0 = ld4_or0(valid[i], eta_in + off);
                const float4 q0 = ld4_or0(valid[i], q_now + off);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float n_j = get(n4, e);
                    vt[i][e] = n_j * one_lam / sig_e + tau_b;
                    mm[i][e] = n_j / (vt[i][e] * sig_e);
                    logvt[i][e] = logf(vt[i][e]);
                    g_cur[i][e] = sigmoid(get(lg, e));
                    mu_cur[i][e] = get(m0, e);
                    eta_cur[i][e] = get(e0, e);
                    q_cur[i][e] = get(q0, e);
                }
            }
        }

        for (int step = 0; step < inner_steps; ++step) {
            float x[LT][4], g_star[LT][4];
#pragma unroll
            for (int i = 0; i < LT; ++i) {
                const float base = hyp[H_BASE * L + LT * ly + i];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float mu_star =
                        mm[i][e] * (get(beta4, e) - q_cur[i][e]);
                    const float u = base - 0.5f * logvt[i][e]
                        + 0.5f * vt[i][e] * mu_star * mu_star;
                    g_star[i][e] = sigmoid(u);
                    x[i][e] = g_star[i][e] * fabsf(mm[i][e]);   // c
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) store_column<LT>(vc, jt + e, lo, x, e);
            __syncthreads();
            // relaxation: sum_k c_k |R_kj|, minus the unit diagonal term
            float acc[LT][4];
            tile_product<LT, 4, true>(acc, R_s, vc, jt, lo);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float rdiag = fabsf(R_s[(jt + e) * T + jt + e]) * scale;
                float c[LT];
                load_lanes<LT>(vc + (jt + e) * RS + lo, c);
#pragma unroll
                for (int i = 0; i < LT; ++i) {
                    const int l = LT * ly + i;
                    const float mu_star =
                        mm[i][e] * (get(beta4, e) - q_cur[i][e]);
                    const float wgt = hyp[H_ACT * L + l]
                        / (1.0f + (acc[i][e] * scale - rdiag * c[i]));
                    g_cur[i][e] =
                        g_cur[i][e] + wgt * (g_star[i][e] - g_cur[i][e]);
                    mu_cur[i][e] =
                        mu_cur[i][e] + wgt * (mu_star - mu_cur[i][e]);
                    x[i][e] = (g_cur[i][e] * mu_cur[i][e] - eta_cur[i][e])
                        * get(mask4, e) * hyp[H_ON * L + l];   // d
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) store_column<LT>(vd, jt + e, lo, x, e);
            __syncthreads();
            // tile-local q refresh: sum_k d_k R_kj - d_j
            tile_product<LT, 4, false>(acc, R_s, vd, jt, lo);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float d[LT];
                load_lanes<LT>(vd + (jt + e) * RS + lo, d);
#pragma unroll
                for (int i = 0; i < LT; ++i) {
                    q_cur[i][e] = q_cur[i][e] + acc[i][e] * scale - d[i];
                    eta_cur[i][e] = eta_cur[i][e] + d[i];
                }
            }
        }

        // the keep gate, the tile's outputs, and d_t into vc (whose last
        // readers passed the step's second barrier)
        unsigned moved = 0u;   // bit e: some lane's d_t at jt + e is nonzero
        {
            float dt[LT][4];
#pragma unroll
            for (int i = 0; i < LT; ++i) {
                const float on = hyp[H_ON * L + LT * ly + i];
                const size_t off = lane_base[i] + t0 + jt;
                const float4 lg = ld4_or0(valid[i], logits_in + off);
                const float4 m0 = ld4_or0(valid[i], mu_in + off);
                const float4 e0 = ld4_or0(valid[i], eta_in + off);
                float out_l[4], out_m[4], out_e[4], out_d[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float eta0 = get(e0, e);
                    float d_t = (eta_cur[i][e] - eta0) * get(mask4, e) * on;
                    const bool keep = fabsf(d_t) >= ETA_DIFF_EPS;
                    d_t = keep ? d_t : 0.0f;
                    dt[i][e] = d_t;
                    moved |= d_t != 0.0f ? 1u << e : 0u;
                    const float u_new = logf(fmaxf(g_cur[i][e], 1e-30f))
                        - log1pf(-fminf(g_cur[i][e], 1.0f - 1e-7f));
                    out_l[e] = keep ? u_new : get(lg, e);
                    out_m[e] = keep ? mu_cur[i][e] : get(m0, e);
                    const float eta_new = eta0 + d_t;
                    out_e[e] = eta_new;
                    out_d[e] = eta_new - eta0;
                }
                if (valid[i]) {
                    *reinterpret_cast<float4*>(logits_out + off) =
                        make_float4(out_l[0], out_l[1], out_l[2], out_l[3]);
                    *reinterpret_cast<float4*>(mu_out + off) =
                        make_float4(out_m[0], out_m[1], out_m[2], out_m[3]);
                    *reinterpret_cast<float4*>(eta_out + off) =
                        make_float4(out_e[0], out_e[1], out_e[2], out_e[3]);
                    *reinterpret_cast<float4*>(eta_diff + off) =
                        make_float4(out_d[0], out_d[1], out_d[2], out_d[3]);
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
                store_column<LT>(vc, jt + e, lo, dt, e);
        }
        publish_rows<4>(moved, tx, w, tid, rows_s);
        __syncthreads();   // d_t of every lane and the row words in place
        // R_s is read no more in this tile: the next float tile's copy
        if constexpr (!kInt8<Tile>) {
            if (t0 + T < B)
                stage_tile_f32<SWEEP_THREADS>(D, B, t0 + T, R_s, tid);
        }
        rank_t_update<LT, SWEEP_THREADS / 32>(D, B, t0, nz, rows_s, first_s, vc, q_in, q_out,
                          lane_base, valid, scale, tx, w, lo, tid);
    }
}

// ---------------------------------------------------------------- coupling
constexpr int CC = 128;          // output coordinates per CTA (one slab)
constexpr int KC = 32;           // source coordinates per pipeline chunk
constexpr int AST = KC + 4;      // row stride (floats) of a staged diff chunk
// row stride (bytes) of a staged U^T chunk: eight rows' 16-byte words fall
// in distinct banks
constexpr int SST = KC + 16;
constexpr int RAW = CC * SST;    // bytes of a staged int8 chunk (>= KC * CC)
constexpr int STAGES = 3;        // cp.async ring depth: 2 chunks ahead
constexpr int CG = 2;            // float4 groups of coordinates a thread owns
constexpr int TX = CC / (4 * CG);   // threads across a slab
static_assert(KC % 16 == 0 && KC * CC <= RAW, "staging layout");
// A float chunk is staged raw as well, 4 times the bytes: in the source
// orientation with rows of KC + 4 floats (so that the transposing
// conversion reads eight rows' 16-byte words from distinct banks). Its raw
// ring has 2 stages, not STAGES: a raw chunk is needed only until its
// conversion, one iteration before its product, so chunk n + 2 may take
// chunk n's stage. With the diff ring of STAGES and the two W buffers that
// is 110 KiB at 100 lanes, 2 CTAs an SM.
template <class Tile>
constexpr int raw_stride = kInt8<Tile> ? SST : KC + 4;
template <class Tile>
constexpr int raw_elems = kInt8<Tile> ? RAW : CC * (KC + 4);
template <class Tile>
constexpr int raw_stages = kInt8<Tile> ? STAGES : 2;
// tile elements a 16-byte cp.async moves
template <class Tile>
constexpr int per_copy = 16 / static_cast<int>(sizeof(Tile));

// A cursor over the chunks of block b's slab that hold a nonzero, in the
// incident tiles with a flagged end: position p in inc_tile (ascending o),
// chunk k of the tile's K loop, the tile o and its other block (as ~other
// where b is the tile's source), read once per tile, and which chunks of
// k's window of 32 hold a nonzero (bit j: chunk (k & ~31) + j), read once
// per window.
struct Cursor {
    int p, k, o, other;
    unsigned mask;

    __device__ __forceinline__ bool as_src() const { return other < 0; }
    __device__ __forceinline__ int other_block() const {
        return other < 0 ? ~other : other;
    }
};

// The walk. Every thread of the CTA steps its cursor alike (the window
// masks come from a warp ballot).
struct TileWalk {
    const int* inc_tile;
    const int* off_src;
    const int* off_dst;
    const int* blk_mask;
    const uint8_t* off_nz;   // (n_off, nb32, nb32): nonzero 32 x 32 blocks
    int b, end, nk, nb32, x4;   // x4: the slab's first 32-column block

    // Whether chunk k of tile o holds a nonzero in this slab: W[k][c] is
    // U[c0 + c][k0 + k] (4 row blocks, 1 column block) or U[k0 + k][c0 + c]
    // (1 row block, 4 column blocks, one aligned word of flags).
    __device__ __forceinline__ bool nonzero(int o, bool as_src, int k) const {
        const uint8_t* f = off_nz + static_cast<size_t>(o) * nb32 * nb32;
        if (as_src)
            return f[x4 * nb32 + k] | f[(x4 + 1) * nb32 + k]
                | f[(x4 + 2) * nb32 + k] | f[(x4 + 3) * nb32 + k];
        return *reinterpret_cast<const unsigned*>(f + k * nb32 + x4) != 0u;
    }
    // The first tile at or after position p with a flagged end (its window
    // not read yet: k = -32).
    __device__ __forceinline__ Cursor tile(int p) const {
        for (; p < end; ++p) {
            const int o = inc_tile[p];
            const int s = off_src[o], d = off_dst[o];
            if (blk_mask[s] || blk_mask[d])
                return Cursor{p, -32, o, s == b ? ~d : s, 0u};
        }
        return Cursor{end, 0, 0, 0, 0u};
    }
    // The first nonzero chunk at or after chunk k of c's tile, else of a
    // later tile with a flagged end.
    __device__ __forceinline__ Cursor seek(Cursor c, int k) const {
        while (c.p < end) {
            while (k < nk) {
                if ((k & ~31) != (c.k & ~31)) {
                    const int kj = (k & ~31) + static_cast<int>(threadIdx.x % 32);
                    c.mask = __ballot_sync(
                        0xffffffffu, kj < nk && nonzero(c.o, c.as_src(), kj));
                }
                c.k = k;
                const unsigned m = c.mask >> (k & 31);
                if (m) {
                    c.k = k + __ffs(m) - 1;
                    return c;
                }
                k = (k & ~31) + 32;
            }
            c = tile(c.p + 1);
            k = 0;
        }
        return c;
    }
    __device__ __forceinline__ Cursor at(int p) const { return seek(tile(p), 0); }
    __device__ __forceinline__ void advance(Cursor& c) const {
        c = seek(c, c.k + 1);
    }
};

// Issue the cp.async copies of cursor c's chunk into one ring stage: the
// (L, KC) diff rows of lanes s0.. (zero past S) and the U chunk (int8 or
// float), rows k (U[k0 + k][c0 ..], b the tile's destination) or columns k
// (U[c0 + c][k0 ..], b its source).
template <int L, int NT, class Tile>
__device__ __forceinline__ void stage_chunk(
    const Cursor& c, float* a, Tile* u, const Tile* __restrict__ off,
    const float* __restrict__ diff, int c0, int s0, int S, int NB, int B) {
    const int k0 = c.k * KC;
    const int other = c.other_block();
#pragma unroll
    for (int j = 0; j < (L * (KC / 4) + NT - 1) / NT; ++j) {
        const int i = threadIdx.x + j * NT;
        if (i < L * (KC / 4)) {
            const int l = i / (KC / 4), part = i % (KC / 4);
            const bool ok = s0 + l < S;
            const float* src = ok ? diff + lane_off(s0 + l, other, NB, B) + k0
                + 4 * part : diff;
            cp_async16(a + l * AST + 4 * part, src, ok);
        }
    }
    const Tile* U = off + static_cast<size_t>(c.o) * B * B;
    const bool as_src = c.as_src();
    constexpr int PC = per_copy<Tile>, RST = raw_stride<Tile>;
#pragma unroll
    for (int j = 0; j < (KC * CC / PC + NT - 1) / NT; ++j) {
        const int i = threadIdx.x + j * NT;
        if (i < KC * CC / PC) {
            if (as_src) {
                const int r = i / (KC / PC), part = i % (KC / PC);
                cp_async16(u + r * RST + PC * part,
                           U + static_cast<size_t>(c0 + r) * B + k0 + PC * part,
                           true);
            } else {
                const int r = i / (CC / PC), part = i % (CC / PC);
                cp_async16(u + r * CC + PC * part,
                           U + static_cast<size_t>(k0 + r) * B + c0 + PC * part,
                           true);
            }
        }
    }
}

// A staged chunk as exact floats W[k][c] (KC, CC): U's rows as they are, or
// its columns transposed, so that both orientations feed one loop. A float
// chunk's rows are copied, its columns transposed from their padded rows.
template <int NT>
__device__ __forceinline__ void convert_chunk(bool as_src, const float* u,
                                              float* w) {
    if (as_src) {
        for (int i = threadIdx.x; i < CC * (KC / 4); i += NT) {
            const int c = i % CC, h = i / CC;
            const float4 f = ld4(u + c * raw_stride<float> + 4 * h);
            float* col = w + 4 * h * CC + c;
            col[0] = f.x;
            col[CC] = f.y;
            col[2 * CC] = f.z;
            col[3 * CC] = f.w;
        }
    } else {
        for (int i = threadIdx.x; i < KC * CC / 4; i += NT)
            reinterpret_cast<float4*>(w)[i] = ld4(u + 4 * i);
    }
}

template <int NT>
__device__ __forceinline__ void convert_chunk(bool as_src, const int8_t* u,
                                              float* w) {
    if (as_src) {
        for (int i = threadIdx.x; i < CC * (KC / 16); i += NT) {
            const int c = i % CC, h = i / CC;
            const int4 v = *reinterpret_cast<const int4*>(u + c * SST + 16 * h);
            const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float4 f = i8x4_to_f32(words[j]);
                float* col = w + (16 * h + 4 * j) * CC + c;
                col[0] = f.x;
                col[CC] = f.y;
                col[2 * CC] = f.z;
                col[3 * CC] = f.w;
            }
        }
    } else {
        for (int i = threadIdx.x; i < KC * CC / 4; i += NT)
            reinterpret_cast<float4*>(w)[i] = i8x4_to_f32(
                *reinterpret_cast<const int*>(u + 4 * i));
    }
}

// acc[i][4 g + e] += sum over the chunk's k, ascending, of a[lane][k] W[k][c]
// for the thread's lanes ty + TY i and columns c = 4 TX g + 4 tx + e. The
// four k of a step have their W and diff loaded together.
template <int LT, int TY>
__device__ __forceinline__ void mma_chunk(float (&acc)[LT][4 * CG],
                                          const float* a, const float* w,
                                          int tx, int ty) {
#pragma unroll
    for (int k4 = 0; k4 < KC; k4 += 4) {
        float4 wv[4][CG];
        float4 av[LT];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int g = 0; g < CG; ++g)
                wv[j][g] = *reinterpret_cast<const float4*>(
                    w + (k4 + j) * CC + 4 * TX * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < LT; ++i)
            av[i] = *reinterpret_cast<const float4*>(a + (ty + TY * i) * AST + k4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < LT; ++i) {
                const float x = j == 0 ? av[i].x : j == 1 ? av[i].y
                    : j == 2 ? av[i].z : av[i].w;
#pragma unroll
                for (int g = 0; g < CG; ++g) {
                    acc[i][4 * g] = fmaf(x, wv[j][g].x, acc[i][4 * g]);
                    acc[i][4 * g + 1] = fmaf(x, wv[j][g].y, acc[i][4 * g + 1]);
                    acc[i][4 * g + 2] = fmaf(x, wv[j][g].z, acc[i][4 * g + 2]);
                    acc[i][4 * g + 3] = fmaf(x, wv[j][g].w, acc[i][4 * g + 3]);
                }
            }
        }
    }
}

// One CTA per (entry of `slabs`: b * (B / CC) + slab for a block's slab
// that some coupling tile can change; lane tile of L = LT * TY lanes).
// Thread (tx, ty), TX by TY of them, owns lanes ty + TY i (i < LT) and the
// coordinates c0 + 4 TX g + 4 tx .. +3 (g < CG). The walk
// takes only the tiles with a flagged end and skips their chunks that are
// zero in the slab (exact zero products), so a CTA with none returns at
// once. q is updated in place: a CTA reads diff and writes only q[its
// lanes, b, its slab]. off is (n_off, B, B) of Tile: int8, or float
// (scale 1).
template <int LT, int TY, class Tile>
__global__ void __launch_bounds__(TX * TY, 2)
coupling_pass_s(const Tile* __restrict__ off,
                const int* __restrict__ off_src,
                const int* __restrict__ off_dst,
                const int* __restrict__ inc_ptr,
                const int* __restrict__ inc_tile,
                const int* __restrict__ blk_mask,
                const uint8_t* __restrict__ off_nz,
                const int* __restrict__ slabs,
                const float* __restrict__ diff,
                float* __restrict__ q,
                int S, int NB, int B, float scale) {
    constexpr int L = LT * TY, NT = TX * TY;
    extern __shared__ __align__(16) unsigned char smem[];
    float* a_s = reinterpret_cast<float*>(smem);        // STAGES x (L, AST)
    float* w_s = a_s + STAGES * L * AST;                 // 2 x (KC, CC)
    // raw_stages<Tile> x raw_elems<Tile>
    Tile* u_s = reinterpret_cast<Tile*>(w_s + 2 * KC * CC);
    constexpr int RS = raw_stages<Tile>, RE = raw_elems<Tile>;

    const int entry = slabs[blockIdx.x];
    const int b = entry / (B / CC);
    const int c0 = entry % (B / CC) * CC;
    const int s0 = blockIdx.y * L;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    const TileWalk walk{inc_tile, off_src, off_dst, blk_mask, off_nz, b,
                        inc_ptr[b + 1], B / KC, B / 32, c0 / 32};

    // chunk n of the walk goes to ring stage n % STAGES (its raw chunk to
    // raw stage n % RS) and W buffer n % 2;
    // one cursor stages chunks STAGES - 1 = 2 ahead of the product, and each
    // is converted into W one iteration before its product. Bit n % STAGES
    // of `srcs` / `ends` says whether staged chunk n is of a tile that b is
    // the source of / the last chunk of its tile.
    Cursor cl = walk.at(inc_ptr[b]);
    int staged = 0;
    unsigned srcs = 0u, ends = 0u;
    auto stage = [&]() {
        const int st = staged % STAGES;
        stage_chunk<L, NT>(cl, a_s + st * L * AST, u_s + staged % RS * RE, off,
                           diff, c0, s0, S, NB, B);
        const int p = cl.p;
        const unsigned bit = 1u << st;
        srcs = cl.as_src() ? srcs | bit : srcs & ~bit;
        walk.advance(cl);
        ends = cl.p != p ? ends | bit : ends & ~bit;
        ++staged;
    };
    for (int st = 0; st < STAGES - 1; ++st) {
        if (cl.p < walk.end) stage();
        cp_async_commit();
    }
    cp_async_wait<STAGES - 2>();   // chunk 0 has landed
    __syncthreads();
    if (staged > 0) convert_chunk<NT>(srcs & 1u, u_s, w_s);

    float acc[LT][4 * CG];
#pragma unroll
    for (int i = 0; i < LT; ++i)
#pragma unroll
        for (int j = 0; j < 4 * CG; ++j) acc[i][j] = 0.0f;

    for (int n = 0; n < staged; ++n) {
        cp_async_wait<STAGES - 3>();   // chunk n + 1 has landed
        __syncthreads();   // ... for every thread; chunk n - 1 is done
        if (cl.p < walk.end) stage();
        cp_async_commit();
        if (n + 1 < staged)
            convert_chunk<NT>((srcs >> ((n + 1) % STAGES)) & 1u,
                              u_s + ((n + 1) % RS) * RE,
                              w_s + ((n + 1) % 2) * KC * CC);
        mma_chunk<LT, TY>(acc, a_s + (n % STAGES) * L * AST,
                             w_s + (n % 2) * KC * CC, tx, ty);
        if ((ends >> (n % STAGES)) & 1u) {
            // the tile is done: q += scale * acc, then a fresh sum
#pragma unroll
            for (int i = 0; i < LT; ++i) {
                const int s = s0 + ty + TY * i;
                if (s < S) {
                    float* qr = q + lane_off(s, b, NB, B) + c0 + 4 * tx;
#pragma unroll
                    for (int g = 0; g < CG; ++g) {
                        float4 v = *reinterpret_cast<float4*>(qr + 4 * TX * g);
                        v.x = fmaf(acc[i][4 * g], scale, v.x);
                        v.y = fmaf(acc[i][4 * g + 1], scale, v.y);
                        v.z = fmaf(acc[i][4 * g + 2], scale, v.z);
                        v.w = fmaf(acc[i][4 * g + 3], scale, v.w);
                        *reinterpret_cast<float4*>(qr + 4 * TX * g) = v;
                    }
                }
#pragma unroll
                for (int j = 0; j < 4 * CG; ++j) acc[i][j] = 0.0f;
            }
        }
    }
    cp_async_wait<0>();
}

cudaError_t set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

bool bad_shape(int S, int nb, int B) {
    return S < 0 || nb < 0 || nb > 65535 || B <= 0 || B % T != 0;
}

template <int LT, class Tile>
cudaError_t launch_sweep(const void* diag, const void* diag_nz,
                         const void* beta, const void* nn, const void* mask,
                         const void* logits_in, const void* mu_in,
                         const void* eta_in, const void* q_in,
                         void* logits_out, void* mu_out, void* eta_out,
                         void* q_out, void* eta_diff, const void* blk_mask,
                         const void* hyper, int S, int nb, int B, float scale,
                         int inner_steps, cudaStream_t stream) {
    constexpr int L = 4 * LT;
    const size_t smem = (T * T + 2 * T * row_stride(LT) + N_HYP * L)
        * sizeof(float) + (T / NZ) * sizeof(unsigned) + B / NZ * sizeof(int)
        + (B / NZ) * (B / NZ);
    cudaError_t err = set_smem(
        reinterpret_cast<const void*>(cavi_block_sweep_s<LT, Tile>), smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + L - 1) / L, nb);
    cavi_block_sweep_s<LT, Tile><<<grid, SWEEP_THREADS, smem, stream>>>(
        static_cast<const Tile*>(diag), static_cast<const uint8_t*>(diag_nz),
        static_cast<const float*>(beta), static_cast<const float*>(nn),
        static_cast<const float*>(mask), static_cast<const float*>(logits_in),
        static_cast<const float*>(mu_in), static_cast<const float*>(eta_in),
        static_cast<const float*>(q_in), static_cast<float*>(logits_out),
        static_cast<float*>(mu_out), static_cast<float*>(eta_out),
        static_cast<float*>(q_out), static_cast<float*>(eta_diff),
        static_cast<const int*>(blk_mask), static_cast<const float*>(hyper),
        S, nb, B, scale, inner_steps);
    return cudaGetLastError();
}

template <int LT, int TY, class Tile>
cudaError_t launch_coupling(const void* off, const void* off_src,
                            const void* off_dst, const void* inc_ptr,
                            const void* inc_tile, const void* blk_mask,
                            const void* off_nz, const void* slabs,
                            int n_slabs, const void* diff,
                            void* q, int S, int nb, int B, float scale,
                            cudaStream_t stream) {
    constexpr int L = LT * TY;
    const size_t smem = (STAGES * L * AST + 2 * KC * CC) * sizeof(float)
        + raw_stages<Tile> * raw_elems<Tile> * sizeof(Tile);
    cudaError_t err = set_smem(
        reinterpret_cast<const void*>(coupling_pass_s<LT, TY, Tile>), smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_slabs, (S + L - 1) / L);
    coupling_pass_s<LT, TY, Tile><<<grid, TX * TY, smem, stream>>>(
        static_cast<const Tile*>(off), static_cast<const int*>(off_src),
        static_cast<const int*>(off_dst), static_cast<const int*>(inc_ptr),
        static_cast<const int*>(inc_tile), static_cast<const int*>(blk_mask),
        static_cast<const uint8_t*>(off_nz), static_cast<const int*>(slabs),
        static_cast<const float*>(diff), static_cast<float*>(q), S, nb, B,
        scale);
    return cudaGetLastError();
}

// The lane tile L's instance of cavi_block_sweep_s for Tile: 4, 8, 16 or 20
// lanes.
template <class Tile>
int sweep_by_lane_tile(const void* diag, const void* diag_nz,
                       const void* beta, const void* nn, const void* mask,
                       const void* logits_in, const void* mu_in,
                       const void* eta_in, const void* q_in, void* logits_out,
                       void* mu_out, void* eta_out, void* q_out,
                       void* eta_diff, const void* blk_mask,
                       const void* hyper, int S, int nb, int B, float scale,
                       int inner_steps, int L, void* stream) {
    if (bad_shape(S, nb, B) || inner_steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    const auto st = static_cast<cudaStream_t>(stream);
#define SWEEP_ARGS diag, diag_nz, beta, nn, mask, logits_in, mu_in, eta_in, \
        q_in, logits_out, mu_out, eta_out, q_out, eta_diff, blk_mask, hyper, \
        S, nb, B, scale, inner_steps, st
    cudaError_t err;
    switch (L) {
    case 4: err = launch_sweep<1, Tile>(SWEEP_ARGS); break;
    case 8: err = launch_sweep<2, Tile>(SWEEP_ARGS); break;
    case 16: err = launch_sweep<4, Tile>(SWEEP_ARGS); break;
    case 20: err = launch_sweep<5, Tile>(SWEEP_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef SWEEP_ARGS
    return static_cast<int>(err);
}

// The lane tile L's instance of coupling_pass_s for Tile: 4, 16, 32 or 100
// lanes.
template <class Tile>
int coupling_by_lane_tile(const void* off, const void* off_src,
                          const void* off_dst, const void* inc_ptr,
                          const void* inc_tile, const void* blk_mask,
                          const void* off_nz, const void* slabs,
                          const void* eta_diff, void* q, int n_slabs, int S,
                          int nb, int B, float scale, int L, void* stream) {
    if (bad_shape(S, nb, B) || B % CC != 0 || n_slabs < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_slabs == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    const auto st = static_cast<cudaStream_t>(stream);
#define COUPLING_ARGS off, off_src, off_dst, inc_ptr, inc_tile, blk_mask, \
        off_nz, slabs, n_slabs, eta_diff, q, S, nb, B, scale, st
    cudaError_t err;
    switch (L) {
    case 4: err = launch_coupling<1, 4, Tile>(COUPLING_ARGS); break;
    case 16: err = launch_coupling<4, 4, Tile>(COUPLING_ARGS); break;
    case 32: err = launch_coupling<4, 8, Tile>(COUPLING_ARGS); break;
    case 100: err = launch_coupling<5, 20, Tile>(COUPLING_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef COUPLING_ARGS
    return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); it never synchronizes. B must be a positive multiple of T.
//
// cavi_block_sweep_s on int8 tiles (_launch) or float32 tiles (_f32_launch)
// with the lane tile L, one of the kernel's instances: 4, 8, 16 or 20
// lanes. The state tensors (and float tiles) must be 16-byte aligned.
#define SWEEP_PARAMS const void* diag, const void* diag_nz, \
        const void* beta, const void* nn, const void* mask, \
        const void* logits_in, const void* mu_in, const void* eta_in, \
        const void* q_in, void* logits_out, void* mu_out, void* eta_out, \
        void* q_out, void* eta_diff, const void* blk_mask, \
        const void* hyper, int S, int nb, int B, float scale, \
        int inner_steps, int L, void* stream
#define SWEEP_ARGS diag, diag_nz, beta, nn, mask, logits_in, mu_in, eta_in, \
        q_in, logits_out, mu_out, eta_out, q_out, eta_diff, blk_mask, hyper, \
        S, nb, B, scale, inner_steps, L, stream
int cavi_block_sweep_s_launch(SWEEP_PARAMS) {
    return sweep_by_lane_tile<int8_t>(SWEEP_ARGS);
}

int cavi_block_sweep_s_f32_launch(SWEEP_PARAMS) {
    return sweep_by_lane_tile<float>(SWEEP_ARGS);
}
#undef SWEEP_PARAMS
#undef SWEEP_ARGS

// coupling_pass_s on int8 tiles (_launch) or float32 tiles (_f32_launch)
// in place on q for the (block, slab) entries slabs[0 .. n_slabs), with the
// lane tile L, one of the kernel's instances: 4, 16, 32 or 100 lanes.
#define COUPLING_PARAMS const void* off, const void* off_src, \
        const void* off_dst, const void* inc_ptr, const void* inc_tile, \
        const void* blk_mask, const void* off_nz, const void* slabs, \
        const void* eta_diff, void* q, int n_slabs, int S, int nb, int B, \
        float scale, int L, void* stream
#define COUPLING_ARGS off, off_src, off_dst, inc_ptr, inc_tile, blk_mask, \
        off_nz, slabs, eta_diff, q, n_slabs, S, nb, B, scale, L, stream
int coupling_pass_s_launch(COUPLING_PARAMS) {
    return coupling_by_lane_tile<int8_t>(COUPLING_ARGS);
}

int coupling_pass_s_f32_launch(COUPLING_PARAMS) {
    return coupling_by_lane_tile<float>(COUPLING_ARGS);
}
#undef COUPLING_PARAMS
#undef COUPLING_ARGS

}  // extern "C"
