// Hopper (sm_90a) CUDA kernels for the blocked CAVI sweep of the sparse
// Gaussian-mixture prior (VIPRSMix, K slab components and the null), with a
// plain C interface for ctypes (ops/_build.py).
//
// cavi_block_sweep_mix_s1 replaces the TPU kernels _mix_sweep_kernel (the
// single-model all-active sweep, viprs_tpu/ops/cavi_pallas.py:700; every
// block flagged, |R_jj| read from the tile) and the sweep part of
// _mix_skip_kernel (the active-block sweep, cavi_pallas.py:1037; the
// activity mask, the variant mask as the unit diagonal).
// cavi_block_sweep_mix_s replaces _mix_sweep_kernel_batch (S lanes,
// cavi_pallas.py:849) and the sweep part of _mix_skip_kernel_batch (the
// union of the live lanes' activity, cavi_pallas.py:1593). The coupling tiles
// after them are the spike-and-slab passes coupling_pass_s1 / coupling_pass_s
// (cavi_s1.cu, cavi_s.cu) on the sweep's eta change: the same operation on
// the same (S, NB, B) eta and q planes. Their plain PyTorch versions are
// ops/cavi_mix.mix_block_sweep and ops/cavi_torch.coupling_pass.
//
// What bounds them on the card. Single model at K = 3 on the 1.1M-variant
// genome (NB = 1133, B = 1024): over the diagonal tiles' nonzero 32 x 32
// blocks (114,067 of 1,160,192) and the state planes, 0.21 GB and 3.3
// GFLOP, 0.063 ms at 3.35 TB/s (every tile dense: 1.19 GB of int8 tiles,
// 0.38 ms). But each coordinate's two products per inner step are one fmaf
// chain of T = 128 terms in ascending order (the bits of the earlier
// kernel), so a block's 8 tiles x 8 steps are a chain of 16,384 dependent
// FMA at least: the kernel is bound by each CTA's latency, not by the
// card's rates. cavi_block_sweep_mix_s1: one CTA of 128 threads per block;
// thread j holds column j of the (T, T) tile as 128 floats in registers, so
// the chains read only the lane vector (a broadcast, four ahead) from
// shared memory; the next tile's int8 bytes and per-coordinate inputs, and
// this tile's flagged 32 x 32 blocks outside it, arrive by cp.async while
// the steps run; the rank-T update takes the tile's own columns from the
// registers and the rest from the flagged blocks only; K (1..8) is a
// template parameter. The spike-and-slab sweep cavi_block_sweep_s1
// (cavi_s1.cu) has the same design; the pieces both use are in s1_tile.cuh.
//
// S = 20 lanes at K = 3 (NB = 1133): if every tile were dense, per lane
// and block 8 tiles x (8 inner steps x 2 x 128^2 + 128 x 1024) = 3.1e6 FMA,
// 7.1e10 per sweep, 2.13 ms at the published 67 TFLOP/s FP32; over the
// genome's nonzero 32 x 32 blocks only (92,055 of 145,024 inside the (T, T)
// tiles, 114,067 of 1,160,192 in all), 3.25e10 FMA, 0.97 ms, against 1.7 GB
// of state traffic (0.51 ms). cavi_block_sweep_mix_s has
// cavi_block_sweep_s's design (cavi_s.cu; the pieces both use are in
// lane_tile.cuh): one CTA per (lane tile of L lanes, LD block), L = 4, 8 or
// 20 picked by S and K (cavi_cuda.mix_sweep_lane_tile), so each diagonal
// tile is dequantized once into shared memory for up to 20 lanes. Thread
// (warp w, tx, ly) owns LT = L/4
// lanes x E coordinates of the tile: E = 4 (128 threads) at L = 4 and 8,
// E = 2 (256 threads) at L = 20, so that 20 lanes x K = 3 of state fit in
// registers. Through the inner steps it keeps each element's K gamma and
// mu, q and eta in registers (2K + 2 values), and the softmax's per-element
// constants (n (1 + lambda) / sigma_eps, mm_k and log vt_k: 1 + 2K values)
// in its own slots of shared memory; mu* is recomputed after the product,
// and c and d are re-read from the lane vector. The two (T, T) products are
// register-tiled: per k one float4 (E = 4) or float2 (E = 2) of R's row and
// LT lane values feed E LT FFMA, |R| an operand modifier. The lane vector
// (c, then d) is double-buffered in shared memory: two barriers per inner
// step. The lanes' hyperparameters and the softmax's constant per component
// sit in shared memory. q lives in q_out, read from q_in until a chunk's
// first write, and the rank-T update walks only the 32 x 32 blocks
// BlockLD.diag_nz flags, skipping groups of 8 rows where every lane's change
// is exactly zero (lane_tile.cuh).
//
// Instances: L = 4 for every K, L = 8 and 20 for K <= 3 (14 in all; a thread
// of the 8- and 20-lane tiles holds 8 and 10 elements, whose 2K + 2 state
// values would spill past K = 3). Every output is the same fmaf chain, with
// the same expressions in the same order, as in the earlier lane-group
// kernel (8 lanes a CTA, a thread per coordinate and 4 lanes), so its outputs
// are bit-identical to that kernel's (chip_smoke.py's M4 holds the mixture
// grid's per-lane nit and h2 to them) and a lane's result does not
// depend on S, its lane tile or its place in it. No atomics; every result is
// deterministic. Transcendentals are the exact expf/logf/log1pf (no fast
// math). There is no keep gate (the mixture kernels have none).
//
// Both kernels are templated on the LD tile's element type as well. The
// float32 instances of cavi_block_sweep_mix_s1 (float LD, scale 1.0) load
// each tile column from global memory and read the flagged outer blocks
// there (s1_tile.cuh; cavi_s1.cu says why), with the int8 instances'
// expressions. cavi_block_sweep_mix_s lives in mix_lane.cuh: its int8
// instances are built here, its float32 instances in cavi_mix_s_f32.cu (a
// translation unit of their own, so that nvcc builds both halves side by
// side); a float tile is copied into R_s by cp.async and the rank-T update
// reads float4 rows, as in cavi_block_sweep_s (cavi_s.cu).
//
// Registers and occupancy (nvcc 12.9 -Xptxas -v, sm_90a; no instance
// spills). cavi_block_sweep_mix_s1: 164 / 167 / 167 registers a thread at
// K = 1 / 2 / 3 (launch bounds of 3 CTAs of 4 warps per SM; 68.6 KiB of
// shared memory at K = 3, B = 1024), 224 / 224 / 228 / 236 / 238 at
// K = 4..8 (2 CTAs); its float instances 164 / 166 / 168 and 189 / 194 /
// 199 / 206 / 209 (20.6 KiB at K = 3). Measured on an H100 80GB HBM3 at 700 W (PERF.md;
// chip_smoke.py M5, CUDA-graph replays): 0.34 ms a sweep at K = 3 over the
// genome's 1133 blocks, coupling pass not included (the earlier kernel:
// 1.96 ms), 0.13 ms at every 20th block. cavi_block_sweep_mix_s: at K = 1 / 2 / 3, 128 / 137 / 137
// registers a thread at L = 4, 136 / 161 / 181 at L = 8 and 153 / 185 / 217
// at L = 20; at L = 4 and K = 4..8, 149 / 161 / 172 / 185 / 197; its float
// instances 128 / 139 / 142, 136 / 161 / 181, 149 / 185 / 217 and 154 /
// 166 / 179 / 191 / 203, the same shared memory. Shared
// memory at B = 1024 and K = 3: 172 KiB at L = 20 (one CTA of 8 warps per
// SM), 105 KiB at L = 8 and 87 KiB at L = 4 (2 CTAs of 4 warps); 107 KiB at
// L = 4, K = 8. Measured
// on an H100 80GB HBM3 at 700 W (PERF.md): 6.5 ms a sweep at S = 20, K = 3
// over the genome's 1133 blocks, coupling included; the inner steps take
// 4.9 ms of it.
//
// hyper is (4 + 2K, S) float32 (S = 1 for the single model): rows
// [sigma_eps, lambda_min, active, log_null_pi, tau_beta_0..K-1,
// pi_0..K-1]. The single-model kernel has no step scale and reads no
// active row: its weight is 1 / (1 + c), as in _mix_sweep_kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tile.cuh"
#include "mix_lane.cuh"
#include "s1_tile.cuh"

namespace {

// The per-coordinate inputs a tile reads, staged by cp.async a tile ahead:
// n, beta, the variant mask, eta, then K rows of gamma and K of mu.
__host__ __device__ constexpr int s1_inputs(int K) { return 4 + 2 * K; }

// Shared memory of a cavi_block_sweep_mix_s1 CTA, in this order: the
// block's q (B floats), the lane vectors c / d_t and d (T each), the
// thread's softmax constants vt_k, mm_k, log vt_k (3K rows of T), the
// softmax's constant per component and tau_beta (2K of 16 slots), two
// buffers of a tile's per-coordinate inputs (s1_inputs(K) rows of T), then
// s1_tile_smem<E>(B) (s1_tile.cuh).
template <class E>
__host__ __device__ constexpr size_t s1_smem(int K, int B) {
    return (static_cast<size_t>(B) + 2 * T + 3 * K * T + 16
            + 2 * s1_inputs(K) * T) * sizeof(float)
        + s1_tile_smem<E>(B);
}

// One CTA of T threads per LD block b of the single model. gamma/mu are
// (K, NB, B), eta/q (NB, B), diag_nz (NB, B/32, B/32) uint8, diag
// (NB, B, B) of E (int8 or float). An unflagged block is copied through
// bit-exactly with a zero eta change. Otherwise, per tile of T coordinates
// (the next tile's inputs, and for int8 its bytes, on their way by
// cp.async meanwhile): thread j loads column j of the tile (its
// coordinate's R row, symmetric or not) into T registers (int8: converted
// from the staged tile; float: from global memory) and takes
// inner_steps steps, each the K+1-way softmax (max seeded by log_null_pi,
// the null term added last), the |R| column product for the relaxation
// weight, the gamma/mu update, eta, and the R column product for the
// tile-local q refresh; then the rank-T update q[:] += scale * d^T R[tile
// rows, :] of the block's q in shared memory: the tile's own columns by a
// third column product from the registers, the columns outside the tile
// over the 32 x 32 blocks diag_nz flags only (a warp per 32-column chunk,
// a thread per column; int8 blocks staged by cp.async while the inner
// steps run, float blocks read from global memory). unit_diag: the relaxation's diagonal term is the variant mask
// (_mix_skip_kernel) instead of |R_jj| * scale (_mix_sweep_kernel). Every
// output is the earlier kernel's fmaf chain with its expressions in its
// order: rows or blocks left out of a chain add exact zeros (for finite d).
// Three CTAs an SM (at most 168 registers a thread) hold the column and
// K <= 3's state without spilling; larger K take two.
template <int K, class E>
__global__ void __launch_bounds__(S1_THREADS, K <= 3 ? 3 : 2)
cavi_block_sweep_mix_s1(const E* __restrict__ diag,
                        const uint8_t* __restrict__ diag_nz,
                        const float* __restrict__ beta,
                        const float* __restrict__ nn,
                        const float* __restrict__ mask,
                        const float* __restrict__ gamma_in,
                        const float* __restrict__ mu_in,
                        const float* __restrict__ eta_in,
                        const float* __restrict__ q_in,
                        float* __restrict__ gamma_out,
                        float* __restrict__ mu_out,
                        float* __restrict__ eta_out,
                        float* __restrict__ q_out,
                        float* __restrict__ eta_diff,
                        const int* __restrict__ blk_mask,
                        const float* __restrict__ hyper,
                        int NB, int B, float scale, int inner_steps,
                        int unit_diag) {
    constexpr int NI = s1_inputs(K);
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);   // (B,)
    float* vc = q_s + B;                            // (T,) c, then d_t
    float* vd = vc + T;                             // (T,) d
    float* vt_s = vd + T;                           // (K, T)
    float* mm_s = vt_s + K * T;                     // (K, T)
    float* lv_s = mm_s + K * T;                     // (K, T)
    float* hyp = lv_s + K * T;                      // base_k, tau_k
    float* in_s = hyp + 16;                         // 2 (NI, T)
    // int8 tiles: 2 (T, T) tiles, (S1_WARPS, OUT_SLOTS, NZ, NZ) staged
    // blocks; then the flags
    int8_t* R8 = reinterpret_cast<int8_t*>(in_s + 2 * NI * T);
    int8_t* out_s = R8 + 2 * T * T;
    unsigned char* nz = kInt8<E>
        ? reinterpret_cast<unsigned char*>(
              out_s + S1_WARPS * OUT_SLOTS * NZ * NZ)
        : reinterpret_cast<unsigned char*>(R8);

    const int b = blockIdx.x;
    const int j = threadIdx.x;
    const size_t off = static_cast<size_t>(b) * B;
    const size_t plane = static_cast<size_t>(NB) * B;   // component stride

    if (!blk_mask[b]) {
        for (int c = 4 * j; c < B; c += 4 * S1_THREADS) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                *reinterpret_cast<float4*>(gamma_out + k * plane + off + c) =
                    ld4(gamma_in + k * plane + off + c);
                *reinterpret_cast<float4*>(mu_out + k * plane + off + c) =
                    ld4(mu_in + k * plane + off + c);
            }
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
    // input row r of a tile: n, beta, mask, eta, gamma_k, mu_k
    auto src = [&](int row) {
        return row == 0 ? nn : row == 1 ? beta
            : row == 2 ? mask : row == 3 ? eta_in
            : row < 4 + K ? gamma_in + (row - 4) * plane
            : mu_in + (row - 4 - K) * plane;
    };
    stage_tile_async<NI>(D, B, 0, R8, in_s, off, j, src);
    cp_async_commit();
    stage_flags<S1_THREADS>(diag_nz, b, nb32, nz, j);
    if (j < K) {
        const float tau = hyper[4 + j];
        const float pi = hyper[4 + K + j];
        hyp[j] = logf(pi) - log1pf(-pi) + 0.5f * logf(tau);
        hyp[K + j] = tau;
    }
    for (int c = 4 * j; c < B; c += 4 * S1_THREADS)
        *reinterpret_cast<float4*>(q_s + c) = ld4(q_in + off + c);
    const float sig_e = hyper[0], lam = hyper[1], lnp = hyper[3];
    const int lane = j % 32, w = j / 32;
    int8_t* my_out = out_s + w * OUT_SLOTS * NZ * NZ;   // the warp's slots

    for (int t = 0; t < nt; ++t) {
        const int t0 = t * T;
        if (t + 1 < nt) {
            // the other buffers' last readers passed the last tile's d_t
            // barrier
            const int nxt = (t + 1) & 1;
            stage_tile_async<NI>(D, B, t0 + T, R8 + nxt * T * T,
                                 in_s + nxt * NI * T, off + t0 + T, j, src);
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
        const float* in_t = in_s + (t & 1) * NI * T;
        float r[T];   // column j of the tile
        load_column(r, Rt, D, B, t0, j);

        const size_t jj = off + t0 + j;
        const float n_j = in_t[j];
        const float beta_j = in_t[T + j];
        const float mask_j = in_t[2 * T + j];
        float g[K], m[K], mmax = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float vt = n_j * (1.0f + lam) / sig_e + hyp[K + k];
            const float mm = n_j / (vt * sig_e);
            vt_s[k * T + j] = vt;
            mm_s[k * T + j] = mm;
            lv_s[k * T + j] = logf(vt);
            mmax = fmaxf(mmax, fabsf(mm));
            g[k] = in_t[(4 + k) * T + j];
            m[k] = in_t[(4 + K + k) * T + j];
        }
        const float rdiag = unit_diag
            ? mask_j : fabsf(diag_value(Rt, D, B, t0, j)) * scale;
        const float eta0 = in_t[3 * T + j];
        float eta_cur = eta0;
        float q_cur = q_s[t0 + j];

        for (int step = 0; step < inner_steps; ++step) {
            float ms[K], gs[K], u[K], umax = lnp;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                ms[k] = mm_s[k * T + j] * (beta_j - q_cur);
                u[k] = hyp[k] - 0.5f * lv_s[k * T + j]
                    + 0.5f * vt_s[k * T + j] * ms[k] * ms[k];
                umax = fmaxf(umax, u[k]);
            }
            float denom = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                gs[k] = expf(u[k] - umax);
                denom += gs[k];
            }
            denom += expf(lnp - umax);
            float pip = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                gs[k] = gs[k] / denom;
                pip += gs[k];
            }
            const float c = pip * mmax;
            vc[j] = c;
            __syncthreads();
            // relaxation: sum_k c_k |R_kj|, minus the diagonal term
            const float acc = column_product<true>(r, vc);
            const float wgt = 1.0f / (1.0f + (acc * scale - rdiag * c));
            float eta_new = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                g[k] = g[k] + wgt * (gs[k] - g[k]);
                m[k] = m[k] + wgt * (ms[k] - m[k]);
                eta_new += g[k] * m[k];
            }
            const float d_in = (eta_new - eta_cur) * mask_j;
            vd[j] = d_in;
            __syncthreads();
            // tile-local q refresh: sum_k d_k R_kj - d_j
            const float acc_d = column_product<false>(r, vd);
            q_cur = q_cur + acc_d * scale - d_in;
            eta_cur = eta_cur + d_in;
        }

        const float d_t = (eta_cur - eta0) * mask_j;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            gamma_out[k * plane + jj] = g[k];
            mu_out[k * plane + jj] = m[k];
        }
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

template <int K, class E>
cudaError_t launch_s1(const Args& a) {
    const size_t smem = s1_smem<E>(K, a.B);
    cudaError_t err = set_smem(
        reinterpret_cast<const void*>(cavi_block_sweep_mix_s1<K, E>), smem);
    if (err != cudaSuccess) return err;
    cavi_block_sweep_mix_s1<K, E><<<a.nb, S1_THREADS, smem, a.stream>>>(
        static_cast<const E*>(a.diag), a.diag_nz, a.beta, a.nn, a.mask, a.gamma_in, a.mu_in,
        a.eta_in, a.q_in, a.gamma_out, a.mu_out, a.eta_out, a.q_out,
        a.eta_diff, a.blk_mask, a.hyper, a.nb, a.B, a.scale, a.inner_steps,
        a.unit_diag);
    return cudaGetLastError();
}

template <int K> struct S1 { static cudaError_t run(const Args& a) { return launch_s1<K, int8_t>(a); } };
template <int K> struct S1F { static cudaError_t run(const Args& a) { return launch_s1<K, float>(a); } };
// the int8 instances of cavi_block_sweep_mix_s (mix_lane.cuh)
template <int K> struct SL { static cudaError_t run(const Args& a) { return launch_lanes<K, int8_t>(a); } };

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); it never synchronizes. B must be a positive multiple of T and
// 1 <= K <= 8. cavi_block_sweep_mix_s1 on int8 tiles (_launch) or float32
// tiles (_f32_launch).
int cavi_block_sweep_mix_s1_launch(const void* diag, const void* diag_nz,
                                   const void* beta, const void* nn,
                                   const void* mask, const void* gamma_in,
                                   const void* mu_in, const void* eta_in,
                                   const void* q_in, void* gamma_out,
                                   void* mu_out, void* eta_out, void* q_out,
                                   void* eta_diff, const void* blk_mask,
                                   const void* hyper, int K, int nb, int B,
                                   float scale, int inner_steps, int unit_diag,
                                   void* stream) {
    if (bad_shape(1, K, nb, B) || inner_steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(by_k<S1>(K, make_args(
        diag, diag_nz, beta, nn, mask, gamma_in, mu_in, eta_in, q_in,
        gamma_out, mu_out, eta_out, q_out, eta_diff, blk_mask, hyper, 1, nb, B,
        scale, inner_steps, unit_diag, 1, stream)));
}

int cavi_block_sweep_mix_s1_f32_launch(const void* diag, const void* diag_nz,
                                       const void* beta, const void* nn,
                                       const void* mask, const void* gamma_in,
                                       const void* mu_in, const void* eta_in,
                                       const void* q_in, void* gamma_out,
                                       void* mu_out, void* eta_out,
                                       void* q_out, void* eta_diff,
                                       const void* blk_mask,
                                       const void* hyper, int K, int nb,
                                       int B, float scale, int inner_steps,
                                       int unit_diag, void* stream) {
    if (bad_shape(1, K, nb, B) || inner_steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(by_k<S1F>(K, make_args(
        diag, diag_nz, beta, nn, mask, gamma_in, mu_in, eta_in, q_in,
        gamma_out, mu_out, eta_out, q_out, eta_diff, blk_mask, hyper, 1, nb, B,
        scale, inner_steps, unit_diag, 1, stream)));
}

// cavi_block_sweep_mix_s with the lane tile L: 4, or 8 or 20 for K <= 3.
// The state tensors and diag_nz must be 16-byte aligned.
int cavi_block_sweep_mix_s_launch(const void* diag, const void* diag_nz,
                                  const void* beta, const void* nn,
                                  const void* mask, const void* gamma_in,
                                  const void* mu_in, const void* eta_in,
                                  const void* q_in, void* gamma_out,
                                  void* mu_out, void* eta_out, void* q_out,
                                  void* eta_diff, const void* blk_mask,
                                  const void* hyper, int S, int K, int nb,
                                  int B, float scale, int inner_steps,
                                  int unit_diag, int L, void* stream) {
    if (bad_shape(S, K, nb, B) || inner_steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(by_k<SL>(K, make_args(
        diag, diag_nz, beta, nn, mask, gamma_in, mu_in, eta_in, q_in,
        gamma_out, mu_out, eta_out, q_out, eta_diff, blk_mask, hyper, S, nb,
        B, scale, inner_steps, unit_diag, L, stream)));
}

}  // extern "C"
