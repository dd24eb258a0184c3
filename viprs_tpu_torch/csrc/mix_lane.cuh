// The S-lane mixture sweep cavi_block_sweep_mix_s (K7/K8; cavi_mix.cu says
// what it replaces and how it is laid out) and the launch plumbing of the
// mixture kernels. Its int8-tile instances are built in cavi_mix.cu, its
// float32-tile instances in cavi_mix_s_f32.cu: two translation units that
// nvcc compiles side by side.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_tile.cuh"

namespace {

// The lanes' hyperparameters a cavi_block_sweep_mix_s CTA keeps in shared
// memory, one row of L lanes each: sigma_eps, 1 + lambda_min, active, the
// gate (active > 0), log_null_pi, then K rows of tau_beta and K of the
// softmax's constant log(pi) - log(1 - pi) + log(tau_beta) / 2.
enum { M_SIG, M_ONE_LAM, M_ACT, M_ON, M_LNP, M_TAU };
__host__ __device__ constexpr int mix_hyp_rows(int K) { return M_TAU + 2 * K; }
// The values of a (lane, coordinate) element that a thread keeps in its own
// slots of shared memory through a tile's inner steps: n_j (1 + lambda_min)
// / sigma_eps, then mm_k = n_j / (vt_k sigma_eps) and log vt_k for each k
// (vt_k is that first value plus tau_beta_k).
__host__ __device__ constexpr int mix_slots(int K) { return 1 + 2 * K; }

// The lane tiles (lanes per CTA) of cavi_block_sweep_mix_s and the largest K
// each holds; cavi_cuda.MIX_SWEEP_LANE_TILES lists the same. 20 lanes run
// 256 threads of 2 coordinates each, 4 and 8 lanes 128 threads of 4.
constexpr int MAX_K_L8 = 3, MAX_K_L20 = 3;

// One CTA per (lane tile of L = 4 LT lanes, LD block b); 4 T / E threads.
// gamma/mu are (S, K, NB, B), eta/q (S, NB, B); hyper is (4 + 2K, S);
// diag_nz is (NB, B/32, B/32) uint8. A block with blk_mask[b] == 0, or a
// tile whose lanes all have active == 0, is copied through bit-exactly with
// a zero eta change; within a tile a lane with active == 0 keeps its values
// bit for bit (w = 0, and its eta changes are gated by on = active > 0).
// Thread (warp w, tx, ly) owns lanes LT ly .. + LT - 1 and coordinates
// 8 E w + E tx .. + E - 1 of each tile, and keeps their K gamma and mu, q and
// eta in registers through the inner steps. Per step and element: the
// K+1-way softmax (null term first, as _mix_sweep_kernel_batch sums it) from
// the element's slots, c = pip * max_k |mm_k| into the lane vector; the
// register-tiled |R| product for w = act / (1 + (sum c|R| scale - rdiag c));
// the gamma/mu/eta update with mu* recomputed; d into the other lane vector;
// the R product for the tile-local q refresh. After the tile, the rank-T
// update over the nonzero 32 x 32 blocks (lane_tile.cuh). A lane's
// arithmetic is the same whatever S, its lane tile or its place in it. diag
// is (NB, B, B) of Tile: int8 (dequantized into R_s by load_tile) or float
// (copied into R_s by cp.async, the next tile's copy in flight during the
// rank-T update of this one; scale 1).
template <int K, int LT, int E, class Tile>
__global__ void __launch_bounds__(sweep_threads(E), 256 / sweep_threads(E))
cavi_block_sweep_mix_s(const Tile* __restrict__ diag,
                       const uint8_t* __restrict__ diag_nz,
                       const float* __restrict__ beta,
                       const float* __restrict__ nn,
                       const float* __restrict__ mask,
                       const float* __restrict__ gamma_in,
                       const float* __restrict__ mu_in,
                       const float* __restrict__ eta_in,
                       const float* q_in,   // q_in and q_out: no __restrict__,
                       float* __restrict__ gamma_out,
                       float* __restrict__ mu_out,
                       float* __restrict__ eta_out,
                       float* q_out,        // both are read through q_now
                       float* __restrict__ eta_diff,
                       const int* __restrict__ blk_mask,
                       const float* __restrict__ hyper,
                       int S, int NB, int B, float scale, int inner_steps,
                       int unit_diag) {
    constexpr int NT = sweep_threads(E), NW = NT / 32;
    constexpr int L = 4 * LT, LS = lane_stride(LT), RS = row_stride(LT);
    constexpr int NV = mix_slots(K);
    extern __shared__ __align__(16) unsigned char smem[];
    float* R_s = reinterpret_cast<float*>(smem);          // (T, T)
    float* vc = R_s + T * T;                              // (T, RS): c, d_t
    float* vd = vc + T * RS;                              // (T, RS): d
    float* slot = vd + T * RS;                            // (LT E NV, NT)
    float* hyp = slot + LT * E * NV * NT;                 // (rows, L)
    unsigned* rows_s = reinterpret_cast<unsigned*>(hyp + mix_hyp_rows(K) * L);
    int* first_s = reinterpret_cast<int*>(rows_s + T / NZ);          // B/32
    // the block's diag_nz, (B/32, B/32)
    unsigned char* nz = reinterpret_cast<unsigned char*>(first_s + B / NZ);

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int s0 = blockIdx.x * L;
    const int nl = min(L, S - s0);
    // (lane s, component k, block b) of gamma/mu
    auto koff = [&](int s, int k) { return lane_off(s * K + k, b, NB, B); };

    bool any_on = false;
    for (int l = 0; l < nl; ++l) any_on |= hyper[2 * S + s0 + l] > 0.0f;
    if (!blk_mask[b] || !any_on) {
        for (int l = 0; l < nl; ++l) {
            const int s = s0 + l;
            const size_t off = lane_off(s, b, NB, B);
            for (int c = 4 * tid; c < B; c += 4 * NT) {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    *reinterpret_cast<float4*>(gamma_out + koff(s, k) + c) =
                        ld4(gamma_in + koff(s, k) + c);
                    *reinterpret_cast<float4*>(mu_out + koff(s, k) + c) =
                        ld4(mu_in + koff(s, k) + c);
                }
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
    const int jt = 8 * E * w + E * tx;   // the thread's coordinates in a tile
    const int lo = ly * LS;              // its lanes' offset in a lane-vector row
    if (tid < L) {
        // missing lanes of the last tile: inert values, never written
        const bool ok = tid < nl;
        const int s = s0 + tid;
        const float act = ok ? hyper[2 * S + s] : 0.0f;
        hyp[M_SIG * L + tid] = ok ? hyper[s] : 1.0f;
        hyp[M_ONE_LAM * L + tid] = 1.0f + (ok ? hyper[S + s] : 0.0f);
        hyp[M_ACT * L + tid] = act;
        hyp[M_ON * L + tid] = act > 0.0f ? 1.0f : 0.0f;
        hyp[M_LNP * L + tid] = ok ? hyper[3 * S + s] : -1.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float tau = ok ? hyper[(4 + k) * S + s] : 1.0f;
            const float pi = ok ? hyper[(4 + K + k) * S + s] : 0.25f / K;
            hyp[(M_TAU + k) * L + tid] = tau;
            hyp[(M_TAU + K + k) * L + tid] =
                logf(pi) - log1pf(-pi) + 0.5f * logf(tau);
        }
    }
    const Tile* D = diag + static_cast<size_t>(b) * B * B;
    if constexpr (!kInt8<Tile>) stage_tile_f32<NT>(D, B, 0, R_s, tid);
    const int nb32 = B / NZ;
    stage_flags<NT>(diag_nz, b, nb32, nz, tid);
    __syncthreads();
    // q_out is the block's running q for the CTA's lanes (see
    // stage_first_writes)
    stage_first_writes<NT>(nz, nb32, first_s, tid);
    bool valid[LT];
    size_t lane_base[LT];
#pragma unroll
    for (int i = 0; i < LT; ++i) {
        valid[i] = LT * ly + i < nl;
        lane_base[i] = lane_off(s0 + LT * ly + i, b, NB, B);
    }
    // slot v of the thread's element (i, e), as mix_slots lists them
    auto sl = [&](int i, int e, int v) -> float& {
        return slot[((i * E + e) * NV + v) * NT + tid];
    };

    for (int t0 = 0; t0 < B; t0 += T) {
        if constexpr (kInt8<Tile>)
            load_tile<NT>(D, B, t0, R_s, tid);
        else
            cp_async_wait<0>();
        // R_s loaded; the last tile's q updates and lane-vector reads done
        __syncthreads();

        const size_t jb = static_cast<size_t>(b) * B + t0 + jt;
        const float* q_now = first_s[(t0 + jt) / NZ] < t0 / T ? q_out : q_in;
        float n_j[E], beta_j[E], mask_j[E];
        load_or0<E>(true, nn + jb, n_j);
        load_or0<E>(true, beta + jb, beta_j);
        load_or0<E>(true, mask + jb, mask_j);
        float g[LT][E][K], m[LT][E][K], q_cur[LT][E], eta_cur[LT][E];
#pragma unroll
        for (int i = 0; i < LT; ++i) {
            const int l = LT * ly + i;
            const int s = s0 + l;
            const float sig_e = hyp[M_SIG * L + l];
            const float one_lam = hyp[M_ONE_LAM * L + l];
            const size_t off = lane_base[i] + t0 + jt;
            load_or0<E>(valid[i], eta_in + off, eta_cur[i]);
            load_or0<E>(valid[i], q_now + off, q_cur[i]);
#pragma unroll
            for (int e = 0; e < E; ++e) sl(i, e, 0) = n_j[e] * one_lam / sig_e;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float tau_b = hyp[(M_TAU + k) * L + l];
                float g0[E], m0[E];
                load_or0<E>(valid[i], gamma_in + koff(s, k) + t0 + jt, g0);
                load_or0<E>(valid[i], mu_in + koff(s, k) + t0 + jt, m0);
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const float vt = n_j[e] * one_lam / sig_e + tau_b;
                    sl(i, e, 1 + k) = n_j[e] / (vt * sig_e);
                    sl(i, e, 1 + K + k) = logf(vt);
                    g[i][e][k] = g0[e];
                    m[i][e][k] = m0[e];
                }
            }
        }

        for (int step = 0; step < inner_steps; ++step) {
            float x[LT][E], gs[LT][E][K];
#pragma unroll
            for (int i = 0; i < LT; ++i) {
                const int l = LT * ly + i;
                const float lnp = hyp[M_LNP * L + l];
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const float nv = sl(i, e, 0);
                    const float qd = beta_j[e] - q_cur[i][e];
                    float u[K], umax = lnp, mmax = 0.f;
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        const float mm = sl(i, e, 1 + k);
                        const float vt = nv + hyp[(M_TAU + k) * L + l];
                        const float ms = mm * qd;
                        u[k] = hyp[(M_TAU + K + k) * L + l]
                            - 0.5f * sl(i, e, 1 + K + k) + 0.5f * vt * ms * ms;
                        umax = fmaxf(umax, u[k]);
                        mmax = fmaxf(mmax, fabsf(mm));
                    }
                    float denom = expf(lnp - umax);
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        gs[i][e][k] = expf(u[k] - umax);
                        denom += gs[i][e][k];
                    }
                    float pip = 0.f;
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        gs[i][e][k] = gs[i][e][k] / denom;
                        pip += gs[i][e][k];
                    }
                    x[i][e] = pip * mmax;   // c
                }
            }
#pragma unroll
            for (int e = 0; e < E; ++e) store_column<LT>(vc, jt + e, lo, x, e);
            __syncthreads();
            // relaxation: sum_k c_k |R_kj|, minus the diagonal term
            float acc[LT][E];
            tile_product<LT, E, true>(acc, R_s, vc, jt, lo);
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const float rdiag = unit_diag ? mask_j[e]
                    : fabsf(R_s[(jt + e) * T + jt + e]) * scale;
                float c[LT];
                load_lanes<LT>(vc + (jt + e) * RS + lo, c);
#pragma unroll
                for (int i = 0; i < LT; ++i) {
                    const int l = LT * ly + i;
                    const float wgt = hyp[M_ACT * L + l]
                        / (1.0f + (acc[i][e] * scale - rdiag * c[i]));
                    const float qd = beta_j[e] - q_cur[i][e];
                    float eta_new = 0.f;
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        // mu* recomputed, rounded on its own: contracted
                        // into ms - m it would round once less
                        const float ms = __fmul_rn(sl(i, e, 1 + k), qd);
                        g[i][e][k] = g[i][e][k] + wgt * (gs[i][e][k] - g[i][e][k]);
                        m[i][e][k] = m[i][e][k] + wgt * (ms - m[i][e][k]);
                        eta_new += g[i][e][k] * m[i][e][k];
                    }
                    x[i][e] = (eta_new - eta_cur[i][e]) * mask_j[e]
                        * hyp[M_ON * L + l];   // d
                }
            }
#pragma unroll
            for (int e = 0; e < E; ++e) store_column<LT>(vd, jt + e, lo, x, e);
            __syncthreads();
            // tile-local q refresh: sum_k d_k R_kj - d_j
            tile_product<LT, E, false>(acc, R_s, vd, jt, lo);
#pragma unroll
            for (int e = 0; e < E; ++e) {
                float d[LT];
                load_lanes<LT>(vd + (jt + e) * RS + lo, d);
#pragma unroll
                for (int i = 0; i < LT; ++i) {
                    q_cur[i][e] = q_cur[i][e] + acc[i][e] * scale - d[i];
                    eta_cur[i][e] = eta_cur[i][e] + d[i];
                }
            }
        }

        // the tile's outputs, and d_t into vc (whose last readers passed the
        // step's second barrier, or the tile's first with no inner step)
        unsigned moved = 0u;   // bit e: some lane's d_t at jt + e is nonzero
        {
            float dt[LT][E];
#pragma unroll
            for (int i = 0; i < LT; ++i) {
                const int s = s0 + LT * ly + i;
                const float on = hyp[M_ON * L + LT * ly + i];
                const size_t off = lane_base[i] + t0 + jt;
                float e0[E], out_e[E], out_d[E];
                load_or0<E>(valid[i], eta_in + off, e0);
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const float d_t = (eta_cur[i][e] - e0[e]) * mask_j[e] * on;
                    dt[i][e] = d_t;
                    moved |= d_t != 0.0f ? 1u << e : 0u;
                    const float eta_new = e0[e] + d_t;
                    out_e[e] = eta_new;
                    out_d[e] = eta_new - e0[e];
                }
                if (valid[i]) {
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        float gk[E], mk[E];
#pragma unroll
                        for (int e = 0; e < E; ++e) {
                            gk[e] = g[i][e][k];
                            mk[e] = m[i][e][k];
                        }
                        store_vec<E>(gamma_out + koff(s, k) + t0 + jt, gk);
                        store_vec<E>(mu_out + koff(s, k) + t0 + jt, mk);
                    }
                    store_vec<E>(eta_out + off, out_e);
                    store_vec<E>(eta_diff + off, out_d);
                }
            }
#pragma unroll
            for (int e = 0; e < E; ++e)
                store_column<LT>(vc, jt + e, lo, dt, e);
        }
        publish_rows<E>(moved, tx, w, tid, rows_s);
        __syncthreads();   // d_t of every lane and the row words in place
        // R_s is read no more in this tile: the next float tile's copy
        if constexpr (!kInt8<Tile>) {
            if (t0 + T < B) stage_tile_f32<NT>(D, B, t0 + T, R_s, tid);
        }
        rank_t_update<LT, NW>(D, B, t0, nz, rows_s, first_s, vc, q_in, q_out,
                              lane_base, valid, scale, tx, w, lo, tid);
    }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

bool bad_shape(int S, int K, int nb, int B) {
    return S < 0 || K < 1 || K > 8 || nb < 0 || nb > 65535 || B <= 0 ||
           B % T != 0;
}

struct Args {
    const void* diag;   // the instance's tile type: int8_t or float
    const uint8_t* diag_nz;
    const float *beta, *nn, *mask, *gamma_in, *mu_in, *eta_in, *q_in;
    float *gamma_out, *mu_out, *eta_out, *q_out, *eta_diff;
    const int* blk_mask;
    const float* hyper;
    int S, nb, B;
    float scale;
    int inner_steps, unit_diag, L;
    cudaStream_t stream;
};

template <int K, int LT, int E, class Tile>
cudaError_t launch_s(const Args& a) {
    constexpr int L = 4 * LT, NT = sweep_threads(E);
    const size_t smem = (T * T + 2 * T * row_stride(LT)
                         + mix_slots(K) * T * L + mix_hyp_rows(K) * L)
        * sizeof(float) + (T / NZ) * sizeof(unsigned)
        + a.B / NZ * sizeof(int) + (a.B / NZ) * (a.B / NZ);
    cudaError_t err = set_smem(
        reinterpret_cast<const void*>(cavi_block_sweep_mix_s<K, LT, E, Tile>),
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + L - 1) / L, a.nb);
    cavi_block_sweep_mix_s<K, LT, E, Tile><<<grid, NT, smem, a.stream>>>(
        static_cast<const Tile*>(a.diag), a.diag_nz, a.beta, a.nn, a.mask,
        a.gamma_in, a.mu_in, a.eta_in, a.q_in, a.gamma_out, a.mu_out, a.eta_out, a.q_out,
        a.eta_diff, a.blk_mask, a.hyper, a.S, a.nb, a.B, a.scale,
        a.inner_steps, a.unit_diag);
    return cudaGetLastError();
}

// K is a template parameter: one instantiation per supported value.
template <template <int> class F>
cudaError_t by_k(int K, const Args& a) {
    switch (K) {
        case 1: return F<1>::run(a);
        case 2: return F<2>::run(a);
        case 3: return F<3>::run(a);
        case 4: return F<4>::run(a);
        case 5: return F<5>::run(a);
        case 6: return F<6>::run(a);
        case 7: return F<7>::run(a);
        case 8: return F<8>::run(a);
        default: return cudaErrorInvalidValue;
    }
}

Args make_args(const void* diag, const void* diag_nz, const void* beta,
               const void* nn, const void* mask, const void* gamma_in,
               const void* mu_in, const void* eta_in, const void* q_in,
               void* gamma_out, void* mu_out, void* eta_out, void* q_out,
               void* eta_diff, const void* blk_mask, const void* hyper, int S,
               int nb, int B, float scale, int inner_steps, int unit_diag,
               int L, void* stream) {
    return Args{diag,
                static_cast<const uint8_t*>(diag_nz),
                static_cast<const float*>(beta),
                static_cast<const float*>(nn), static_cast<const float*>(mask),
                static_cast<const float*>(gamma_in), static_cast<const float*>(mu_in),
                static_cast<const float*>(eta_in), static_cast<const float*>(q_in),
                static_cast<float*>(gamma_out), static_cast<float*>(mu_out),
                static_cast<float*>(eta_out), static_cast<float*>(q_out),
                static_cast<float*>(eta_diff), static_cast<const int*>(blk_mask),
                static_cast<const float*>(hyper), S, nb, B, scale, inner_steps,
                unit_diag, L, static_cast<cudaStream_t>(stream)};
}

// The instance of cavi_block_sweep_mix_s for Tile and the lane tile a.L: 4
// lanes for every K, 8 and 20 up to MAX_K_L8 / MAX_K_L20
// (cavi_cuda.mix_sweep_lane_tile).
template <int K, class Tile>
cudaError_t launch_lanes(const Args& a) {
    if (a.L == 4) return launch_s<K, 1, 4, Tile>(a);
    if constexpr (K <= MAX_K_L8) {
        if (a.L == 8) return launch_s<K, 2, 4, Tile>(a);
    }
    if constexpr (K <= MAX_K_L20) {
        if (a.L == 20) return launch_s<K, 5, 2, Tile>(a);
    }
    return cudaErrorInvalidValue;
}

}  // namespace
