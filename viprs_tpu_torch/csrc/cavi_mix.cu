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
// What bounds them on the card. Single model: one read of the int8
// diagonal tiles (1.19 GB on the 1.1M-variant genome at B = 1024, 0.35 ms at
// 3.35 TB/s); the FMA count is ~1% of the FP32 peak's worth. S = 20 lanes at
// K = 3: per lane and block 8 tiles x (8 inner steps x 2 x 128^2 + 128 x
// 1024) = 3.1e6 FMA, 7.1e10 FMA per sweep, 2.1 ms at the published 67
// TFLOP/s FP32, against ~2.3 GB of state traffic (0.7 ms). This first
// version is simple on purpose: f32 FMA on the CUDA cores, one CTA per
// block (and lane group), the diagonal tile dequantized into shared memory
// once per tile, each thread holding the K component values of its
// coordinates in registers (K is a template parameter, 1..8). No atomics:
// every result is deterministic. Transcendentals are the exact
// expf/logf/log1pf (no fast math); log(var_tau) is hoisted out of the inner
// steps. There is no keep gate (the mixture kernels have none).
//
// hyper is (4 + 2K, S) float32 (S = 1 for the single model): rows
// [sigma_eps, lambda_min, active, log_null_pi, tau_beta_0..K-1,
// pi_0..K-1]. The single-model kernel has no step scale and reads no
// active row: its weight is 1 / (1 + c), as in _mix_sweep_kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

constexpr int T = 128;           // tile width: coordinates updated jointly
constexpr int THREADS = 256;     // B / 4 int8 column groups at B = 1024
constexpr int LG = 8;            // lanes per CTA of the S-lane kernel
constexpr int HALF = LG / 2;     // lanes per thread in its inner steps
static_assert(THREADS == 2 * T, "two owners per coordinate in the lane kernel");
static_assert(HALF == 4, "a thread's lanes travel as one float4");

// Dequantize the (T, T) diagonal tile at (t0, t0) of a block into R_s.
__device__ __forceinline__ void load_tile(const int8_t* D, int B, int t0,
                                          float* R_s, int tid) {
    for (int w = tid; w < T * T / 4; w += THREADS) {
        const int r = w / (T / 4), c4 = w % (T / 4);
        reinterpret_cast<float4*>(R_s)[w] = i8x4_to_f32(
            *reinterpret_cast<const int*>(
                D + static_cast<size_t>(t0 + r) * B + t0 + 4 * c4));
    }
}

// One CTA per LD block b of the single model. gamma/mu are (K, NB, B),
// eta/q (NB, B). An unflagged block is copied through bit-exactly with a
// zero eta change. Otherwise, per tile of T coordinates: threads 0..T-1 (one
// per coordinate) take inner_steps steps, each the K+1-way softmax (max
// seeded by log_null_pi), the |R_tt| matvec for the relaxation weight, the
// gamma/mu update, eta, and the R_tt matvec for the tile-local q refresh;
// then all threads apply the rank-T update q[:] += scale * d^T R[tile rows,
// :] to the block's q in shared memory (rows whose d_k is exactly zero are
// skipped: exact). unit_diag: the relaxation's diagonal term is the variant
// mask (_mix_skip_kernel) instead of |R_jj| * scale (_mix_sweep_kernel).
template <int K>
__global__ void __launch_bounds__(THREADS)
cavi_block_sweep_mix_s1(const int8_t* __restrict__ diag,
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
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);           // (B,)
    float* v_s = q_s + B;                                  // (T,) c or d
    float* R_s = v_s + T;                                  // (T, T)

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const size_t off = static_cast<size_t>(b) * B;
    const size_t plane = static_cast<size_t>(NB) * B;     // component stride

    if (!blk_mask[b]) {
        for (int j = tid; j < B; j += THREADS) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                gamma_out[k * plane + off + j] = gamma_in[k * plane + off + j];
                mu_out[k * plane + off + j] = mu_in[k * plane + off + j];
            }
            eta_out[off + j] = eta_in[off + j];
            q_out[off + j] = q_in[off + j];
            eta_diff[off + j] = 0.0f;
        }
        return;
    }

    const float sig_e = hyper[0], lam = hyper[1], lnp = hyper[3];
    float tau_b[K], base[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        tau_b[k] = hyper[4 + k];
        const float pi = hyper[4 + K + k];
        base[k] = logf(pi) - log1pf(-pi) + 0.5f * logf(tau_b[k]);
    }

    for (int j = tid; j < B; j += THREADS) q_s[j] = q_in[off + j];

    const int8_t* D = diag + static_cast<size_t>(b) * B * B;
    const bool owner = tid < T;
    for (int t0 = 0; t0 < B; t0 += T) {
        load_tile(D, B, t0, R_s, tid);
        __syncthreads();   // R_s loaded; q_s updates of the last tile done

        const size_t jj = off + t0 + tid;
        float beta_j = 0.f, mask_j = 0.f, mmax = 0.f, rdiag = 0.f;
        float eta0 = 0.f, eta_cur = 0.f, q_cur = 0.f;
        float vt[K], mm[K], logvt[K], g[K], m[K];
#pragma unroll
        for (int k = 0; k < K; ++k) vt[k] = mm[k] = logvt[k] = g[k] = m[k] = 0.f;
        if (owner) {
            const float n_j = nn[jj];
            beta_j = beta[jj];
            mask_j = mask[jj];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                vt[k] = n_j * (1.0f + lam) / sig_e + tau_b[k];
                mm[k] = n_j / (vt[k] * sig_e);
                logvt[k] = logf(vt[k]);
                mmax = fmaxf(mmax, fabsf(mm[k]));
                g[k] = gamma_in[k * plane + jj];
                m[k] = mu_in[k * plane + jj];
            }
            rdiag = unit_diag ? mask_j : fabsf(R_s[tid * T + tid]) * scale;
            eta0 = eta_in[jj];
            eta_cur = eta0;
            q_cur = q_s[t0 + tid];
        }

        for (int step = 0; step < inner_steps; ++step) {
            float ms[K], gs[K], c = 0.f, d_in = 0.f;
            if (owner) {
                float u[K], umax = lnp;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    ms[k] = mm[k] * (beta_j - q_cur);
                    u[k] = base[k] - 0.5f * logvt[k] + 0.5f * vt[k] * ms[k] * ms[k];
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
                c = pip * mmax;
                v_s[tid] = c;
            }
            __syncthreads();
            if (owner) {
                // relaxation: sum_k c_k |R_kj|, minus the diagonal term
                float acc = 0.f;
                for (int k = 0; k < T; ++k)
                    acc = fmaf(v_s[k], fabsf(R_s[k * T + tid]), acc);
                const float w = 1.0f / (1.0f + (acc * scale - rdiag * c));
                float eta_new = 0.f;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    g[k] = g[k] + w * (gs[k] - g[k]);
                    m[k] = m[k] + w * (ms[k] - m[k]);
                    eta_new += g[k] * m[k];
                }
                d_in = (eta_new - eta_cur) * mask_j;
            }
            __syncthreads();
            if (owner) v_s[tid] = d_in;
            __syncthreads();
            if (owner) {
                // tile-local q refresh: sum_k d_k R_kj - d_j
                float acc = 0.f;
                for (int k = 0; k < T; ++k)
                    acc = fmaf(v_s[k], R_s[k * T + tid], acc);
                q_cur = q_cur + acc * scale - d_in;
                eta_cur = eta_cur + d_in;
            }
            __syncthreads();
        }

        if (owner) {
            const float d_t = (eta_cur - eta0) * mask_j;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                gamma_out[k * plane + jj] = g[k];
                mu_out[k * plane + jj] = m[k];
            }
            const float eta_new = eta0 + d_t;
            eta_out[jj] = eta_new;
            eta_diff[jj] = eta_new - eta0;
            v_s[tid] = d_t;
        }
        __syncthreads();

        // rank-T update over the whole block width (R symmetric)
        const int8_t* rows = D + static_cast<size_t>(t0) * B;
        for (int cg = tid; cg < B / 4; cg += THREADS) {
            float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
            for (int k = 0; k < T; ++k) {
                const float dk = v_s[k];
                if (dk != 0.0f) {
                    const float4 r = i8x4_to_f32(*reinterpret_cast<const int*>(
                        rows + static_cast<size_t>(k) * B + 4 * cg));
                    a0 = fmaf(dk, r.x, a0);
                    a1 = fmaf(dk, r.y, a1);
                    a2 = fmaf(dk, r.z, a2);
                    a3 = fmaf(dk, r.w, a3);
                }
            }
            q_s[4 * cg + 0] += a0 * scale;
            q_s[4 * cg + 1] += a1 * scale;
            q_s[4 * cg + 2] += a2 * scale;
            q_s[4 * cg + 3] += a3 * scale;
        }
        __syncthreads();
        // the stored unit diagonal also moved q at the focal variants
        if (owner) q_s[t0 + tid] -= v_s[tid];
    }
    __syncthreads();
    for (int j = tid; j < B; j += THREADS) q_out[off + j] = q_s[j];
}

// One CTA per (lane group g, LD block b) of S lanes. gamma/mu are
// (S, K, NB, B), eta/q (S, NB, B). A block with blk_mask[b] == 0, or a group
// whose lanes all have active == 0, is copied through bit-exactly with a
// zero eta change; within a group a lane with active == 0 keeps its values
// bit for bit (w = 0, and its eta changes are gated by on = active > 0).
// Thread (j, h) owns coordinate j of the lanes h*HALF .. h*HALF+HALF-1 of
// the group: per step the softmax (null term first, as
// _mix_sweep_kernel_batch sums it), w = active / (1 + c) from one shared
// load of |R| per HALF lanes, the gamma/mu/eta update and the R matvec; after
// each tile every thread applies the rank-T update to four columns of all
// LG lanes (one global int8 word feeds LG lanes), skipping rows where every
// lane's change is exactly zero. Each lane's sums run in a fixed order
// whatever S or its position, so a lane's result does not depend on which
// other lanes are swept with it (lane compaction is exact).
template <int K>
__global__ void __launch_bounds__(THREADS)
cavi_block_sweep_mix_s(const int8_t* __restrict__ diag,
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
                       int S, int NB, int B, float scale, int inner_steps,
                       int unit_diag) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);            // (LG, B)
    float* v_s = q_s + LG * B;                              // (T, LG)
    float* R_s = v_s + T * LG;                              // (T, T)

    const int g = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int s0 = g * LG;
    const int nl = min(LG, S - s0);
    // offsets of (lane s, component k, block b) and (lane s, block b)
    auto koff = [&](int s, int k) { return ((static_cast<size_t>(s) * K + k) * NB + b) * B; };
    auto loff = [&](int s) { return (static_cast<size_t>(s) * NB + b) * B; };

    bool any_on = false;
    for (int l = 0; l < nl; ++l) any_on |= hyper[2 * S + s0 + l] > 0.0f;
    if (!blk_mask[b] || !any_on) {
        for (int l = 0; l < nl; ++l) {
            const int s = s0 + l;
            for (int j = tid; j < B; j += THREADS) {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    gamma_out[koff(s, k) + j] = gamma_in[koff(s, k) + j];
                    mu_out[koff(s, k) + j] = mu_in[koff(s, k) + j];
                }
                eta_out[loff(s) + j] = eta_in[loff(s) + j];
                q_out[loff(s) + j] = q_in[loff(s) + j];
                eta_diff[loff(s) + j] = 0.0f;
            }
        }
        return;
    }

    const int j = tid & (T - 1);   // coordinate within the tile
    const int h = tid / T;         // which half of the lane group
    float sig_e[HALF], lam[HALF], act[HALF], on[HALF], lnp[HALF];
    float tau_b[HALF][K], base[HALF][K];
    bool valid[HALF];
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
        const int l = h * HALF + i;
        valid[i] = l < nl;
        const int s = s0 + l;
        // missing lanes of the last group: inert values, never written
        sig_e[i] = valid[i] ? hyper[s] : 1.0f;
        lam[i] = valid[i] ? hyper[S + s] : 0.0f;
        act[i] = valid[i] ? hyper[2 * S + s] : 0.0f;
        lnp[i] = valid[i] ? hyper[3 * S + s] : -1.0f;
        on[i] = act[i] > 0.0f ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            tau_b[i][k] = valid[i] ? hyper[(4 + k) * S + s] : 1.0f;
            const float pi = valid[i] ? hyper[(4 + K + k) * S + s] : 0.25f / K;
            base[i][k] = logf(pi) - log1pf(-pi) + 0.5f * logf(tau_b[i][k]);
        }
    }

    for (int l = 0; l < LG; ++l)
        for (int c = tid; c < B; c += THREADS)
            q_s[l * B + c] = l < nl ? q_in[loff(s0 + l) + c] : 0.0f;

    const int8_t* D = diag + static_cast<size_t>(b) * B * B;
    float4* my_v = reinterpret_cast<float4*>(v_s + j * LG + h * HALF);
    for (int t0 = 0; t0 < B; t0 += T) {
        load_tile(D, B, t0, R_s, tid);
        __syncthreads();   // R_s loaded; q_s updates of the last tile done

        const size_t jb = static_cast<size_t>(b) * B + t0 + j;
        const float n_j = nn[jb], beta_j = beta[jb], mask_j = mask[jb];
        const float rdiag = unit_diag ? mask_j : fabsf(R_s[j * T + j]) * scale;
        float vt[HALF][K], mm[HALF][K], logvt[HALF][K];
        float gk[HALF][K], mk[HALF][K], mmax[HALF];
        float eta0[HALF], eta_cur[HALF], q_cur[HALF], c[HALF], d[HALF];
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
            const int s = s0 + h * HALF + i;
            mmax[i] = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                vt[i][k] = n_j * (1.0f + lam[i]) / sig_e[i] + tau_b[i][k];
                mm[i][k] = n_j / (vt[i][k] * sig_e[i]);
                logvt[i][k] = logf(vt[i][k]);
                mmax[i] = fmaxf(mmax[i], fabsf(mm[i][k]));
                gk[i][k] = valid[i] ? gamma_in[koff(s, k) + t0 + j] : 0.0f;
                mk[i][k] = valid[i] ? mu_in[koff(s, k) + t0 + j] : 0.0f;
            }
            eta0[i] = valid[i] ? eta_in[loff(s) + t0 + j] : 0.0f;
            eta_cur[i] = eta0[i];
            q_cur[i] = q_s[(h * HALF + i) * B + t0 + j];
        }

        for (int step = 0; step < inner_steps; ++step) {
            float ms[HALF][K], gs[HALF][K];
#pragma unroll
            for (int i = 0; i < HALF; ++i) {
                float u[K], umax = lnp[i];
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    ms[i][k] = mm[i][k] * (beta_j - q_cur[i]);
                    u[k] = base[i][k] - 0.5f * logvt[i][k]
                        + 0.5f * vt[i][k] * ms[i][k] * ms[i][k];
                    umax = fmaxf(umax, u[k]);
                }
                float denom = expf(lnp[i] - umax);
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    gs[i][k] = expf(u[k] - umax);
                    denom += gs[i][k];
                }
                float pip = 0.f;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    gs[i][k] = gs[i][k] / denom;
                    pip += gs[i][k];
                }
                c[i] = pip * mmax[i];
            }
            *my_v = make_float4(c[0], c[1], c[2], c[3]);
            __syncthreads();
            // relaxation: sum_k c_k |R_kj|, minus the diagonal term
            float acc[HALF] = {0.f, 0.f, 0.f, 0.f};
            for (int k = 0; k < T; ++k) {
                const float r = fabsf(R_s[k * T + j]);
                const float4 v = reinterpret_cast<const float4*>(
                    v_s + k * LG + h * HALF)[0];
                acc[0] = fmaf(v.x, r, acc[0]);
                acc[1] = fmaf(v.y, r, acc[1]);
                acc[2] = fmaf(v.z, r, acc[2]);
                acc[3] = fmaf(v.w, r, acc[3]);
            }
#pragma unroll
            for (int i = 0; i < HALF; ++i) {
                const float w = act[i] / (1.0f + (acc[i] * scale - rdiag * c[i]));
                float eta_new = 0.f;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    gk[i][k] = gk[i][k] + w * (gs[i][k] - gk[i][k]);
                    mk[i][k] = mk[i][k] + w * (ms[i][k] - mk[i][k]);
                    eta_new += gk[i][k] * mk[i][k];
                }
                d[i] = (eta_new - eta_cur[i]) * mask_j * on[i];
            }
            __syncthreads();
            *my_v = make_float4(d[0], d[1], d[2], d[3]);
            __syncthreads();
            // tile-local q refresh: sum_k d_k R_kj - d_j
            float acc2[HALF] = {0.f, 0.f, 0.f, 0.f};
            for (int k = 0; k < T; ++k) {
                const float r = R_s[k * T + j];
                const float4 v = reinterpret_cast<const float4*>(
                    v_s + k * LG + h * HALF)[0];
                acc2[0] = fmaf(v.x, r, acc2[0]);
                acc2[1] = fmaf(v.y, r, acc2[1]);
                acc2[2] = fmaf(v.z, r, acc2[2]);
                acc2[3] = fmaf(v.w, r, acc2[3]);
            }
#pragma unroll
            for (int i = 0; i < HALF; ++i) {
                q_cur[i] = q_cur[i] + acc2[i] * scale - d[i];
                eta_cur[i] = eta_cur[i] + d[i];
            }
            __syncthreads();
        }

#pragma unroll
        for (int i = 0; i < HALF; ++i) {
            d[i] = (eta_cur[i] - eta0[i]) * mask_j * on[i];
            if (valid[i]) {
                const int s = s0 + h * HALF + i;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    gamma_out[koff(s, k) + t0 + j] = gk[i][k];
                    mu_out[koff(s, k) + t0 + j] = mk[i][k];
                }
                const float eta_new = eta0[i] + d[i];
                eta_out[loff(s) + t0 + j] = eta_new;
                eta_diff[loff(s) + t0 + j] = eta_new - eta0[i];
            }
        }
        *my_v = make_float4(d[0], d[1], d[2], d[3]);
        __syncthreads();

        // rank-T update over the whole block width (R symmetric)
        const int8_t* rows = D + static_cast<size_t>(t0) * B;
        for (int cg = tid; cg < B / 4; cg += THREADS) {
            float a[LG][4];
#pragma unroll
            for (int l = 0; l < LG; ++l)
                a[l][0] = a[l][1] = a[l][2] = a[l][3] = 0.f;
            for (int k = 0; k < T; ++k) {
                const float4 v0 = reinterpret_cast<const float4*>(v_s + k * LG)[0];
                const float4 v1 = reinterpret_cast<const float4*>(v_s + k * LG)[1];
                const float dk[LG] = {v0.x, v0.y, v0.z, v0.w,
                                      v1.x, v1.y, v1.z, v1.w};
                bool any = false;
#pragma unroll
                for (int l = 0; l < LG; ++l) any |= dk[l] != 0.0f;
                if (any) {
                    const float4 r = i8x4_to_f32(*reinterpret_cast<const int*>(
                        rows + static_cast<size_t>(k) * B + 4 * cg));
#pragma unroll
                    for (int l = 0; l < LG; ++l) {
                        a[l][0] = fmaf(dk[l], r.x, a[l][0]);
                        a[l][1] = fmaf(dk[l], r.y, a[l][1]);
                        a[l][2] = fmaf(dk[l], r.z, a[l][2]);
                        a[l][3] = fmaf(dk[l], r.w, a[l][3]);
                    }
                }
            }
#pragma unroll
            for (int l = 0; l < LG; ++l) {
                float* qr = q_s + l * B + 4 * cg;
                qr[0] += a[l][0] * scale;
                qr[1] += a[l][1] * scale;
                qr[2] += a[l][2] * scale;
                qr[3] += a[l][3] * scale;
            }
        }
        __syncthreads();
        // the stored unit diagonal also moved q at the focal variants
#pragma unroll
        for (int i = 0; i < HALF; ++i)
            q_s[(h * HALF + i) * B + t0 + j] -= d[i];
    }
    __syncthreads();
    for (int l = 0; l < nl; ++l)
        for (int c = tid; c < B; c += THREADS)
            q_out[loff(s0 + l) + c] = q_s[l * B + c];
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
    const int8_t* diag;
    const float *beta, *nn, *mask, *gamma_in, *mu_in, *eta_in, *q_in;
    float *gamma_out, *mu_out, *eta_out, *q_out, *eta_diff;
    const int* blk_mask;
    const float* hyper;
    int S, nb, B;
    float scale;
    int inner_steps, unit_diag;
    cudaStream_t stream;
};

template <int K>
cudaError_t launch_s1(const Args& a) {
    const size_t smem = (a.B + T + T * T) * sizeof(float);
    cudaError_t err = set_smem(reinterpret_cast<const void*>(cavi_block_sweep_mix_s1<K>), smem);
    if (err != cudaSuccess) return err;
    cavi_block_sweep_mix_s1<K><<<a.nb, THREADS, smem, a.stream>>>(
        a.diag, a.beta, a.nn, a.mask, a.gamma_in, a.mu_in, a.eta_in, a.q_in,
        a.gamma_out, a.mu_out, a.eta_out, a.q_out, a.eta_diff, a.blk_mask,
        a.hyper, a.nb, a.B, a.scale, a.inner_steps, a.unit_diag);
    return cudaGetLastError();
}

template <int K>
cudaError_t launch_s(const Args& a) {
    const size_t smem = (LG * a.B + T * LG + T * T) * sizeof(float);
    cudaError_t err = set_smem(reinterpret_cast<const void*>(cavi_block_sweep_mix_s<K>), smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + LG - 1) / LG, a.nb);
    cavi_block_sweep_mix_s<K><<<grid, THREADS, smem, a.stream>>>(
        a.diag, a.beta, a.nn, a.mask, a.gamma_in, a.mu_in, a.eta_in, a.q_in,
        a.gamma_out, a.mu_out, a.eta_out, a.q_out, a.eta_diff, a.blk_mask,
        a.hyper, a.S, a.nb, a.B, a.scale, a.inner_steps, a.unit_diag);
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

template <int K> struct S1 { static cudaError_t run(const Args& a) { return launch_s1<K>(a); } };
template <int K> struct SL { static cudaError_t run(const Args& a) { return launch_s<K>(a); } };

Args make_args(const void* diag, const void* beta, const void* nn,
               const void* mask, const void* gamma_in, const void* mu_in,
               const void* eta_in, const void* q_in, void* gamma_out,
               void* mu_out, void* eta_out, void* q_out, void* eta_diff,
               const void* blk_mask, const void* hyper, int S, int nb, int B,
               float scale, int inner_steps, int unit_diag, void* stream) {
    return Args{static_cast<const int8_t*>(diag), static_cast<const float*>(beta),
                static_cast<const float*>(nn), static_cast<const float*>(mask),
                static_cast<const float*>(gamma_in), static_cast<const float*>(mu_in),
                static_cast<const float*>(eta_in), static_cast<const float*>(q_in),
                static_cast<float*>(gamma_out), static_cast<float*>(mu_out),
                static_cast<float*>(eta_out), static_cast<float*>(q_out),
                static_cast<float*>(eta_diff), static_cast<const int*>(blk_mask),
                static_cast<const float*>(hyper), S, nb, B, scale, inner_steps,
                unit_diag, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); it never synchronizes. B must be a positive multiple of T and
// 1 <= K <= 8.
int cavi_block_sweep_mix_s1_launch(const void* diag, const void* beta,
                                   const void* nn, const void* mask,
                                   const void* gamma_in, const void* mu_in,
                                   const void* eta_in, const void* q_in,
                                   void* gamma_out, void* mu_out,
                                   void* eta_out, void* q_out, void* eta_diff,
                                   const void* blk_mask, const void* hyper,
                                   int K, int nb, int B, float scale,
                                   int inner_steps, int unit_diag,
                                   void* stream) {
    if (bad_shape(1, K, nb, B)) return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(by_k<S1>(K, make_args(
        diag, beta, nn, mask, gamma_in, mu_in, eta_in, q_in, gamma_out, mu_out,
        eta_out, q_out, eta_diff, blk_mask, hyper, 1, nb, B, scale,
        inner_steps, unit_diag, stream)));
}

int cavi_block_sweep_mix_s_launch(const void* diag, const void* beta,
                                  const void* nn, const void* mask,
                                  const void* gamma_in, const void* mu_in,
                                  const void* eta_in, const void* q_in,
                                  void* gamma_out, void* mu_out, void* eta_out,
                                  void* q_out, void* eta_diff,
                                  const void* blk_mask, const void* hyper,
                                  int S, int K, int nb, int B, float scale,
                                  int inner_steps, int unit_diag,
                                  void* stream) {
    if (bad_shape(S, K, nb, B)) return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(by_k<SL>(K, make_args(
        diag, beta, nn, mask, gamma_in, mu_in, eta_in, q_in, gamma_out, mu_out,
        eta_out, q_out, eta_diff, blk_mask, hyper, S, nb, B, scale,
        inner_steps, unit_diag, stream)));
}

}  // extern "C"
