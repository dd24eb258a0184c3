// Hopper (sm_90a) CUDA kernels for the single-model (S = 1) blocked CAVI
// sweep of VIPRS, with a plain C interface for ctypes (ops/_build.py).
//
// cavi_block_sweep_s1 replaces the TPU kernels _sweep_kernel_s1 (all-active
// sweep, viprs_tpu/ops/cavi_pallas.py:133) and the first pass of _skip_kernel
// (active-block sweep, cavi_pallas.py:317); coupling_pass_s1 replaces the
// coupling pass _off_pass (cavi_pallas.py:492) and, with every block
// flagged, cavi_jax.refresh_q on the all-active branch. Their plain PyTorch
// versions are ops/cavi_torch.block_sweep and ops/cavi_torch.coupling_pass.
// No atomics; every result is deterministic. Transcendentals are the exact
// expf/logf/log1pf (no fast math), as in the reference.
//
// What bounds cavi_block_sweep_s1 on the card. On the 1.1M-variant genome
// (NB = 1133, B = 1024) over the diagonal tiles' nonzero 32 x 32 blocks
// (114,067 of 1,160,192) and the state planes it needs 0.17 GB, 0.052 ms at
// 3.35 TB/s (every tile dense: 1.19 GB of int8 tiles, 0.37 ms). But each
// coordinate's two products per inner step are one fmaf chain of T = 128
// terms in ascending order (the bits of the earlier kernel), so a block's
// 8 tiles x 8 steps are a chain of 16,384 dependent FMA at least: the
// kernel is bound by each CTA's latency, not by the card's rates.
//
// Design (cavi_block_sweep_mix_s1's, cavi_mix.cu; the pieces both use are
// in s1_tile.cuh): one CTA of 128 threads per block; thread j holds column
// j of the (T, T) tile as 128 floats in registers, so the chains read only
// the lane vector (a broadcast, four ahead) from shared memory; the next
// tile's int8 bytes and per-coordinate inputs, and this tile's flagged
// 32 x 32 blocks outside it, arrive by cp.async while the steps run; the
// rank-T update takes the tile's own columns from the registers and the
// rest from the blocks BlockLD.diag_nz flags only. Every output is the
// earlier kernel's (one CTA of 256 threads, the tile in shared memory):
// the same expressions in the same order, each product one ascending fmaf
// chain, and rows or blocks left out of a chain add exact zeros (for
// finite eta changes).
//
// Float32 (dequantized) LD: both kernels are templated on the tile's
// element type, and their float instances (E = float; the packers' scale
// 1.0, so acc * scale is exact) run the int8 instances' expressions. A
// float (T, T) tile is 64 KB: the int8 layout stored as float32 would need
// ~209 KB of shared memory, one CTA an SM, too few bytes in flight. So a
// float tile is not staged: thread j loads column j straight from global
// memory into its registers (a warp's 32 loads of one row are one 128-byte
// line), and the rank-T update reads every flagged outer block from global
// memory. Float LD does not round small correlations to zero: on the genome
// packed as float32, 458,113 of the 1,160,192 diagonal 32 x 32 blocks are
// nonzero, so the sweep needs 1.9 GB, 0.58 ms at 3.35 TB/s (every tile
// dense 1.44 ms); its inner steps are the int8 kernel's chains. The float
// coupling pass reads a source-orientation row with a whole warp (float4
// loads of the row's flagged blocks, a butterfly of shuffles), each lane's
// elements fixed by block index so that a skipped zero block changes no
// bit; the destination orientation is the int8 one, a coalesced column a
// thread.
//
// Registers and occupancy (nvcc 12.9 -Xptxas -v, sm_90a): launch bounds of
// 3 CTAs of 4 warps per SM (at most 168 registers a thread). int8: 167
// registers, 61.5 KiB of shared memory at B = 1024; float: 164 registers,
// 13.5 KiB. coupling_pass_s1: 72 registers (int8), 48 (float). No spills.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tile.cuh"
#include "s1_tile.cuh"

namespace {

constexpr float ETA_DIFF_EPS = 1e-8f;

__device__ __forceinline__ float sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// The per-coordinate inputs a tile reads, staged by cp.async a tile ahead,
// one row of T each.
enum { IN_N, IN_BETA, IN_MASK, IN_LOGIT, IN_MU, IN_ETA, N_IN };
// The per-coordinate constants of a tile that a thread keeps in its own
// slots of shared memory through the inner steps, one row of T each:
// var_tau, mu_mult and log var_tau.
enum { K_VT, K_MM, K_LOGVT, N_CONST };

// Shared memory of a cavi_block_sweep_s1 CTA, in this order: the block's q
// (B floats), the lane vectors c / d_t and d (T each), the per-coordinate
// constants (N_CONST rows of T), two buffers of a tile's inputs (N_IN rows
// of T), then s1_tile_smem<E>(B) (s1_tile.cuh): 61.5 KiB for int8 tiles at
// B = 1024, 13.5 KiB for float tiles.
template <class E>
size_t sweep_smem(int B) {
    return (static_cast<size_t>(B) + 2 * T + N_CONST * T + 2 * N_IN * T)
        * sizeof(float) + s1_tile_smem<E>(B);
}

// One CTA of T threads per LD block b; state planes (NB, B), diag_nz
// (NB, B/32, B/32) uint8, diag (NB, B, B) of E (int8 or float). A block
// with blk_mask[b] == 0 is copied through bit-exactly with a zero eta
// change. Otherwise, per tile of T coordinates (the next tile's inputs,
// and for int8 its bytes, on their way by cp.async meanwhile): thread j
// loads column j of the tile (its coordinate's R row, symmetric or not)
// into T registers (int8: converted from the staged tile; float: from
// global memory) and takes inner_steps
// gamma-weighted under-relaxed Jacobi steps from a tile-locally refreshed q,
// each the |R| column product for the relaxation weight and the R column
// product for the refresh; the keep gate drops |d_eta| < 1e-8; then the
// rank-T update q[:] += scale * d_t^T R[tile rows, :] of the block's q in
// shared memory: the tile's own columns by a third column product from the
// registers, the columns outside the tile over the 32 x 32 blocks diag_nz
// flags only (a warp per 32-column chunk, a thread per column; int8 blocks
// staged by cp.async while the inner steps run, float blocks read from
// global memory). Float tiles run the same expressions: their scale is 1.0,
// and acc * 1.0f is exact.
//
// hyper: [sigma_eps, tau_beta, pi, active, lambda_min] float32 on the device.
template <class E>
__global__ void __launch_bounds__(S1_THREADS, 3)
cavi_block_sweep_s1(const E* __restrict__ diag,
                    const uint8_t* __restrict__ diag_nz,
                    const float* __restrict__ beta,
                    const float* __restrict__ nn,
                    const float* __restrict__ mask,
                    const float* __restrict__ logits_in,
                    const float* __restrict__ mu_in,
                    const float* __restrict__ eta_in,
                    const float* __restrict__ q_in,
                    float* __restrict__ logits_out,
                    float* __restrict__ mu_out,
                    float* __restrict__ eta_out,
                    float* __restrict__ q_out,
                    float* __restrict__ eta_diff,
                    const int* __restrict__ blk_mask,
                    const float* __restrict__ hyper,
                    int B, float scale, int inner_steps) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);   // (B,)
    float* vc = q_s + B;                            // (T,) c, then d_t
    float* vd = vc + T;                             // (T,) d
    float* k_s = vd + T;                            // (N_CONST, T)
    float* in_s = k_s + N_CONST * T;                // 2 (N_IN, T)
    // int8 tiles: 2 (T, T) tiles, (S1_WARPS, OUT_SLOTS, NZ, NZ) staged
    // blocks; then the flags
    int8_t* R8 = reinterpret_cast<int8_t*>(in_s + 2 * N_IN * T);
    int8_t* out_s = R8 + 2 * T * T;
    unsigned char* nz = kInt8<E>
        ? reinterpret_cast<unsigned char*>(
              out_s + S1_WARPS * OUT_SLOTS * NZ * NZ)
        : reinterpret_cast<unsigned char*>(R8);

    const int b = blockIdx.x;
    const int j = threadIdx.x;
    const size_t off = static_cast<size_t>(b) * B;

    if (!blk_mask[b]) {
        for (int c = 4 * j; c < B; c += 4 * S1_THREADS) {
            *reinterpret_cast<float4*>(logits_out + off + c) =
                ld4(logits_in + off + c);
            *reinterpret_cast<float4*>(mu_out + off + c) =
                ld4(mu_in + off + c);
            *reinterpret_cast<float4*>(eta_out + off + c) =
                ld4(eta_in + off + c);
            *reinterpret_cast<float4*>(q_out + off + c) = ld4(q_in + off + c);
            *reinterpret_cast<float4*>(eta_diff + off + c) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
        return;
    }

    const E* D = diag + static_cast<size_t>(b) * B * B;
    const int nb32 = B / NZ, nt = B / T;
    auto src = [&](int row) {
        return row == IN_N ? nn : row == IN_BETA ? beta
            : row == IN_MASK ? mask : row == IN_LOGIT ? logits_in
            : row == IN_MU ? mu_in : eta_in;
    };
    stage_tile_async<N_IN>(D, B, 0, R8, in_s, off, j, src);
    cp_async_commit();
    stage_flags<S1_THREADS>(diag_nz, b, nb32, nz, j);
    for (int c = 4 * j; c < B; c += 4 * S1_THREADS)
        *reinterpret_cast<float4*>(q_s + c) = ld4(q_in + off + c);
    const float sig_e = hyper[0], tau_b = hyper[1], pi = hyper[2];
    const float act = hyper[3], lam = hyper[4];
    const float on = act > 0.0f ? 1.0f : 0.0f;
    const float base_logit = logf(pi) - log1pf(-pi) + 0.5f * logf(tau_b);
    const int lane = j % 32, w = j / 32;
    int8_t* my_out = out_s + w * OUT_SLOTS * NZ * NZ;   // the warp's slots

    for (int t = 0; t < nt; ++t) {
        const int t0 = t * T;
        if (t + 1 < nt) {
            // the other buffers' last readers passed the last tile's d_t
            // barrier
            const int nxt = (t + 1) & 1;
            stage_tile_async<N_IN>(D, B, t0 + T, R8 + nxt * T * T,
                                   in_s + nxt * N_IN * T, off + t0 + T, j,
                                   src);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        // the tile and its inputs in place; the last tile's q updates and
        // lane-vector and staged-block reads done
        __syncthreads();
        // this tile's flagged blocks outside it, into the warp's slots
        stage_outer_blocks(D, B, t0, nz, nb32, lane, w, my_out);
        const int8_t* Rt = R8 + (t & 1) * T * T;
        const float* in_t = in_s + (t & 1) * N_IN * T;
        float r[T];   // column j of the tile
        load_column(r, Rt, D, B, t0, j);

        const size_t jj = off + t0 + j;
        const float n_j = in_t[IN_N * T + j];
        const float beta_j = in_t[IN_BETA * T + j];
        const float mask_j = in_t[IN_MASK * T + j];
        {
            const float vt = n_j * (1.0f + lam) / sig_e + tau_b;
            k_s[K_VT * T + j] = vt;
            k_s[K_MM * T + j] = n_j / (vt * sig_e);
            k_s[K_LOGVT * T + j] = logf(vt);
        }
        const float rdiag = fabsf(diag_value(Rt, D, B, t0, j)) * scale;
        const float eta0 = in_t[IN_ETA * T + j];
        float q_cur = q_s[t0 + j];
        float g_cur = sigmoid(in_t[IN_LOGIT * T + j]);
        float mu_cur = in_t[IN_MU * T + j];
        float eta_cur = eta0;

        for (int step = 0; step < inner_steps; ++step) {
            const float vt = k_s[K_VT * T + j], mm = k_s[K_MM * T + j];
            const float mu_star = mm * (beta_j - q_cur);
            const float u = base_logit - 0.5f * k_s[K_LOGVT * T + j]
                + 0.5f * vt * mu_star * mu_star;
            const float g_star = sigmoid(u);
            const float c = g_star * fabsf(mm);
            vc[j] = c;
            __syncthreads();
            // relaxation: sum_k c_k |R_kj|, minus the unit diagonal term
            const float acc = column_product<true>(r, vc);
            const float wgt = act / (1.0f + (acc * scale - rdiag * c));
            g_cur = g_cur + wgt * (g_star - g_cur);
            mu_cur = mu_cur + wgt * (mu_star - mu_cur);
            const float d_in = (g_cur * mu_cur - eta_cur) * mask_j * on;
            vd[j] = d_in;
            __syncthreads();
            // tile-local q refresh: sum_k d_k R_kj - d_j
            const float acc_d = column_product<false>(r, vd);
            q_cur = q_cur + acc_d * scale - d_in;
            eta_cur = eta_cur + d_in;
        }

        float d_t = (eta_cur - eta0) * mask_j * on;
        const bool keep = fabsf(d_t) >= ETA_DIFF_EPS;
        d_t = keep ? d_t : 0.0f;
        const float u_new = logf(fmaxf(g_cur, 1e-30f))
            - log1pf(-fminf(g_cur, 1.0f - 1e-7f));
        logits_out[jj] = keep ? u_new : in_t[IN_LOGIT * T + j];
        mu_out[jj] = keep ? mu_cur : in_t[IN_MU * T + j];
        const float eta_new = eta0 + d_t;
        eta_out[jj] = eta_new;
        eta_diff[jj] = eta_new - eta0;
        // vc's last readers passed the last step's second barrier, or the
        // tile's first with no inner step
        vc[j] = d_t;
        cp_async_wait<0>();   // the staged blocks
        __syncthreads();

        // rank-T update (R symmetric), the tile's own columns: the stored
        // unit diagonal also moved q at the focal variants
        const float acc_t = column_product<false>(r, vc);
        q_s[t0 + j] = q_s[t0 + j] + acc_t * scale - d_t;
        // the columns outside the tile: a thread per column of the warp's
        // chunks, each flagged block's 32 rows from its slot (or global
        // memory past the warp's OUT_SLOTS)
        outer_rank_t(D, B, t0, nz, nb32, lane, w, my_out, vc, q_s, scale);
    }
    __syncthreads();
    for (int c = 4 * j; c < B; c += 4 * S1_THREADS)
        *reinterpret_cast<float4*>(q_out + off + c) = ld4(q_s + c);
}

// coupling_pass_s1: q[b, c0 .. c0 + 127] += the coupling tiles incident to
// block b that have a flagged end, in ascending o (the order in which the
// sequential TPU pass adds whole tile contributions), applied to the sweep's
// eta change, in place. One CTA of SLAB = 128 threads per entry of `slabs`
// (BlockLD.cpl_slabs: b * (B / 128) + slab, the slabs of 128 coordinates
// that some tile's nonzero 32 x 32 blocks reach); thread c owns q[b, c0 + c]
// and keeps it in a register through the walk. Warp w's 32 coordinates are
// one 32-block x of the slab: its row block in the tiles b is the source of,
// its column block in those b is the destination of. Per tile, a warp
// ballot over BlockLD.off_nz gives the flagged 32 x 32 blocks along x, and
// only those are read:
//   b == src_o:  q[i] += scale * sum_j U_o[i, j] diff[dst_o, j]
//   b == dst_o:  q[c] += scale * sum_i U_o[i, c] diff[src_o, i]
// Every sum keeps the earlier kernel's bits. That kernel gave each row of
// the source orientation to a warp: lane l summed the char4 groups
// j4 = l (mod 32) in ascending order, as four fmaf each, and a
// __shfl_down_sync tree (16, 8, 4, 2, 1) added the 32 partials. Here one
// thread computes the same 32 partials over the flagged blocks only (lane
// 8 g + e of that warp took group e of the blocks cb = g (mod 4)) and adds
// them in that tree's order. The destination orientation is one
// ascending-i fmaf chain per column, rows with a zero eta change skipped,
// as before. A skipped block or row adds exact zeros (for a finite eta
// change), and every coordinate of the slab takes one q += acc * scale per
// tile with a flagged end, acc = +0 where nothing reaches it.
//
// One difference remains, and only in the sign of a zero: the earlier
// kernel also added +0 to the slabs of b that no tile reaches, which turns
// a q of -0 there into +0. The block sweeps never write -0 into q (each
// writes q + a * scale - d from accumulators that start at +0), so it shows
// only for a caller's q that holds -0.
//
// What bounds it: on the 1.1M-variant genome the 244 coupling tiles hold a
// nonzero in 350 of their 249,856 blocks of 32 x 32, so the data the pass
// needs is a few hundred KB (about 0.3 us at 3.35 TB/s); the launch and the
// chain of dependent reads of each CTA's walk (slab, incident tiles, flags,
// then the blocks) set its time.
constexpr int SLAB = 128;

// The source orientation for the thread's row i of U (32-block x): the
// earlier kernel's warp sum of U[i, :] . v over the flagged blocks.
__device__ __forceinline__ float row_sum(const int8_t* U, const uint8_t* f,
                                        const float* v, int i, int x,
                                        int nb32, int lane, int B) {
    float p[4][8];   // lane 8 g + e's partial of the earlier warp sum
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) p[g][e] = 0.0f;
    const int8_t* row = U + static_cast<size_t>(i) * B;
    for (int cw = 0; cw < nb32; cw += 32) {
        const int cb = cw + lane;
        const unsigned m = __ballot_sync(
            0xffffffffu, cb < nb32 && f[x * nb32 + cb] != 0);
        if (!m) continue;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                if (!((m >> (4 * t + g)) & 1u)) continue;
                const int c = NZ * (cw + 4 * t + g);
                const int4 w0 = *reinterpret_cast<const int4*>(row + c);
                const int4 w1 = *reinterpret_cast<const int4*>(row + c + 16);
                const int words[8] = {w0.x, w0.y, w0.z, w0.w,
                                      w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float4 u = i8x4_to_f32(words[e]);
                    const float4 d = __ldg(reinterpret_cast<const float4*>(
                        v + c + 4 * e));
                    p[g][e] = fmaf(u.x, d.x, p[g][e]);
                    p[g][e] = fmaf(u.y, d.y, p[g][e]);
                    p[g][e] = fmaf(u.z, d.z, p[g][e]);
                    p[g][e] = fmaf(u.w, d.w, p[g][e]);
                }
            }
        }
    }
    // the shuffle tree: lanes l and l + 16, then + 8, + 4, + 2, + 1
    float s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
        s[e] = (p[0][e] + p[2][e]) + (p[1][e] + p[3][e]);
    return ((s[0] + s[4]) + (s[2] + s[6])) + ((s[1] + s[5]) + (s[3] + s[7]));
}

// The source orientation on float tiles, for warp w's 32 rows of U
// (32-block x; lane l owns row 32 x + l): a row at a time, the warp reads
// the row's flagged blocks as float4 (lane 8 g + e: float4 e of each block
// cb = g (mod 4), ascending; four blocks, 512 contiguous bytes, a step),
// one fmaf chain a lane, and a butterfly of __shfl_xor_sync adds the 32
// partials (every lane gets the same bits); the row's owner keeps its sum.
// Which lane sums which element does not depend on the flags, so a skipped
// zero block changes no bit.
__device__ __forceinline__ float row_sums_f32(const float* U,
                                             const uint8_t* f,
                                             const float* v, int x, int nb32,
                                             int lane, int B) {
    const int g = lane / 8, e = lane % 8;
    float mine = 0.0f;
    for (int r = 0; r < NZ; ++r) {
        const float* row = U + static_cast<size_t>(NZ * x + r) * B;
        float p = 0.0f;
        for (int cw = 0; cw < nb32; cw += 32) {
            const int cb = cw + lane;
            const unsigned m = __ballot_sync(
                0xffffffffu, cb < nb32 && f[x * nb32 + cb] != 0);
            for (int t = 0; t < 8; ++t) {
                if (!((m >> (4 * t + g)) & 1u)) continue;
                const int c = NZ * (cw + 4 * t + g) + 4 * e;
                const float4 u = __ldg(reinterpret_cast<const float4*>(
                    row + c));
                const float4 d = __ldg(reinterpret_cast<const float4*>(
                    v + c));
                p = fmaf(u.x, d.x, p);
                p = fmaf(u.y, d.y, p);
                p = fmaf(u.z, d.z, p);
                p = fmaf(u.w, d.w, p);
            }
        }
#pragma unroll
        for (int o = 16; o; o >>= 1)
            p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == r) mine = p;
    }
    return mine;
}

// The destination orientation for the thread's column c of U (32-block x):
// sum over i, ascending, of v[i] U[i, c] over the flagged blocks, rows with
// v[i] == 0 skipped.
template <class E>
__device__ __forceinline__ float column_sum(const E* U, const uint8_t* f,
                                           const float* v, int c, int x,
                                           int nb32, int lane, int B) {
    float a = 0.0f;
    for (int rw = 0; rw < nb32; rw += 32) {
        const int rb = rw + lane;
        unsigned m = __ballot_sync(
            0xffffffffu, rb < nb32 && f[rb * nb32 + x] != 0);
        for (; m; m &= m - 1) {
            const int i0 = NZ * (rw + __ffs(m) - 1);
            const E* col = U + static_cast<size_t>(i0) * B + c;
            TileWord<E> raw[NZ];
#pragma unroll
            for (int i = 0; i < NZ; ++i)
                raw[i] = __ldg(col + static_cast<size_t>(i) * B);
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                const float vi = __ldg(v + i0 + i);
                if (vi != 0.0f) a = fmaf(vi, to_f32(raw[i]), a);
            }
        }
    }
    return a;
}

template <class E>
__global__ void __launch_bounds__(SLAB)
coupling_pass_s1(const E* __restrict__ off,
                 const int* __restrict__ off_src,
                 const int* __restrict__ off_dst,
                 const int* __restrict__ inc_ptr,
                 const int* __restrict__ inc_tile,
                 const int* __restrict__ blk_mask,
                 const uint8_t* __restrict__ off_nz,
                 const int* __restrict__ slabs,
                 const float* __restrict__ diff,
                 float* __restrict__ q,
                 int B, float scale) {
    const int entry = slabs[blockIdx.x];
    const int b = entry / (B / SLAB);
    const int c = entry % (B / SLAB) * SLAB + threadIdx.x;   // the coordinate
    const int lane = threadIdx.x % 32, x = c / NZ, nb32 = B / NZ;
    float* qp = q + static_cast<size_t>(b) * B + c;
    float qv = *qp;
    bool touched = false;
    for (int p = inc_ptr[b]; p < inc_ptr[b + 1]; ++p) {
        const int o = inc_tile[p];
        const int s = off_src[o], d = off_dst[o];
        if (!blk_mask[s] && !blk_mask[d]) continue;
        const E* U = off + static_cast<size_t>(o) * B * B;
        const uint8_t* f = off_nz + static_cast<size_t>(o) * nb32 * nb32;
        float acc;
        if constexpr (kInt8<E>)
            acc = s == b
                ? row_sum(U, f, diff + static_cast<size_t>(d) * B, c, x,
                          nb32, lane, B)
                : column_sum(U, f, diff + static_cast<size_t>(s) * B, c, x,
                             nb32, lane, B);
        else   // s == b is the same for the whole CTA: the warps stay whole
            acc = s == b
                ? row_sums_f32(U, f, diff + static_cast<size_t>(d) * B, x,
                               nb32, lane, B)
                : column_sum(U, f, diff + static_cast<size_t>(s) * B, c, x,
                             nb32, lane, B);
        qv += acc * scale;
        touched = true;
    }
    if (touched) *qp = qv;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

template <class E>
int launch_sweep_s1(const void* diag, const void* diag_nz, const void* beta,
                    const void* nn, const void* mask, const void* logits_in,
                    const void* mu_in, const void* eta_in, const void* q_in,
                    void* logits_out, void* mu_out, void* eta_out,
                    void* q_out, void* eta_diff, const void* blk_mask,
                    const void* hyper, int nb, int B, float scale,
                    int inner_steps, void* stream) {
    if (nb < 0 || B <= 0 || B % T != 0 || inner_steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0) return static_cast<int>(cudaGetLastError());
    const size_t smem = sweep_smem<E>(B);
    cudaError_t err = set_smem(
        reinterpret_cast<const void*>(cavi_block_sweep_s1<E>), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cavi_block_sweep_s1<E><<<nb, S1_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(diag), static_cast<const uint8_t*>(diag_nz),
        static_cast<const float*>(beta), static_cast<const float*>(nn),
        static_cast<const float*>(mask), static_cast<const float*>(logits_in),
        static_cast<const float*>(mu_in), static_cast<const float*>(eta_in),
        static_cast<const float*>(q_in), static_cast<float*>(logits_out),
        static_cast<float*>(mu_out), static_cast<float*>(eta_out),
        static_cast<float*>(q_out), static_cast<float*>(eta_diff),
        static_cast<const int*>(blk_mask), static_cast<const float*>(hyper),
        B, scale, inner_steps);
    return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_coupling_s1(const void* off, const void* off_src,
                       const void* off_dst, const void* inc_ptr,
                       const void* inc_tile, const void* blk_mask,
                       const void* off_nz, const void* slabs,
                       const void* eta_diff, void* q, int n_slabs, int nb,
                       int B, float scale, void* stream) {
    if (nb < 0 || n_slabs < 0 || B <= 0 || B % SLAB != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_slabs == 0) return static_cast<int>(cudaGetLastError());
    coupling_pass_s1<E><<<n_slabs, SLAB, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(off), static_cast<const int*>(off_src),
        static_cast<const int*>(off_dst), static_cast<const int*>(inc_ptr),
        static_cast<const int*>(inc_tile), static_cast<const int*>(blk_mask),
        static_cast<const uint8_t*>(off_nz), static_cast<const int*>(slabs),
        static_cast<const float*>(eta_diff), static_cast<float*>(q), B,
        scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); it never synchronizes. B must be a positive multiple of T.
// cavi_block_sweep_s1 over the nb blocks of int8 tiles (_launch) or float32
// tiles (_f32_launch); the state tensors, beta, n, mask and diag_nz must be
// 16-byte aligned.
int cavi_block_sweep_s1_launch(const void* diag, const void* diag_nz,
                               const void* beta, const void* nn,
                               const void* mask, const void* logits_in,
                               const void* mu_in, const void* eta_in,
                               const void* q_in, void* logits_out,
                               void* mu_out, void* eta_out, void* q_out,
                               void* eta_diff, const void* blk_mask,
                               const void* hyper, int nb, int B, float scale,
                               int inner_steps, void* stream) {
    return launch_sweep_s1<int8_t>(
        diag, diag_nz, beta, nn, mask, logits_in, mu_in, eta_in, q_in,
        logits_out, mu_out, eta_out, q_out, eta_diff, blk_mask, hyper, nb, B,
        scale, inner_steps, stream);
}

int cavi_block_sweep_s1_f32_launch(const void* diag, const void* diag_nz,
                                   const void* beta, const void* nn,
                                   const void* mask, const void* logits_in,
                                   const void* mu_in, const void* eta_in,
                                   const void* q_in, void* logits_out,
                                   void* mu_out, void* eta_out, void* q_out,
                                   void* eta_diff, const void* blk_mask,
                                   const void* hyper, int nb, int B,
                                   float scale, int inner_steps,
                                   void* stream) {
    return launch_sweep_s1<float>(
        diag, diag_nz, beta, nn, mask, logits_in, mu_in, eta_in, q_in,
        logits_out, mu_out, eta_out, q_out, eta_diff, blk_mask, hyper, nb, B,
        scale, inner_steps, stream);
}

// coupling_pass_s1 in place on q for the (block, slab) entries
// slabs[0 .. n_slabs), on int8 (_launch) or float32 (_f32_launch) coupling
// tiles. off and eta_diff must be 16-byte aligned.
int coupling_pass_s1_launch(const void* off, const void* off_src,
                            const void* off_dst, const void* inc_ptr,
                            const void* inc_tile, const void* blk_mask,
                            const void* off_nz, const void* slabs,
                            const void* eta_diff, void* q, int n_slabs,
                            int nb, int B, float scale, void* stream) {
    return launch_coupling_s1<int8_t>(off, off_src, off_dst, inc_ptr,
                                      inc_tile, blk_mask, off_nz, slabs,
                                      eta_diff, q, n_slabs, nb, B, scale,
                                      stream);
}

int coupling_pass_s1_f32_launch(const void* off, const void* off_src,
                                const void* off_dst, const void* inc_ptr,
                                const void* inc_tile, const void* blk_mask,
                                const void* off_nz, const void* slabs,
                                const void* eta_diff, void* q, int n_slabs,
                                int nb, int B, float scale, void* stream) {
    return launch_coupling_s1<float>(off, off_src, off_dst, inc_ptr,
                                     inc_tile, blk_mask, off_nz, slabs,
                                     eta_diff, q, n_slabs, nb, B, scale,
                                     stream);
}

}  // extern "C"
