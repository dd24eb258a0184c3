// Hopper (sm_90a) CUDA kernels for the S-lane (model grid, S > 1) blocked
// CAVI sweep of VIPRS, with a plain C interface for ctypes (ops/_build.py).
//
// cavi_block_sweep_s replaces the TPU kernel _sweep_kernel (the S-lane
// all-active sweep, viprs_tpu/ops/cavi_pallas.py:49) and the sweep part of
// _skip_kernel_s (the S-lane active-block sweep, cavi_pallas.py:1191);
// coupling_pass_s replaces the coupling pass _off_pass at rows = Sp
// (cavi_pallas.py:492, called from _skip_kernel_s) and, with every block
// flagged, cavi_jax.refresh_q after _sweep_kernel. Their plain PyTorch
// versions are ops/cavi_torch.block_sweep and ops/cavi_torch.coupling_pass.
//
// What bounds them on the card: at S = 100 on the 1.1M-variant genome
// (NB = 1133, B = 1024) one sweep needs about 3.6e11 FMA, i.e. 0.71 TFLOP:
// per lane and block, 8 tiles x (8 inner steps x 2 x 128^2 + 128 x 1024),
// times 113,300 lane-blocks. That is about 10.6 ms at the H100 SXM's
// published 67 TFLOP/s FP32, against 4.2 GB of state traffic (1.25 ms at
// 3.35 TB/s) and a 1.19 GB LD read. So unlike S = 1 the sweep is bound by
// CUDA-core FP32. This first version is simple on purpose: f32 FMA, no
// tensor cores (TF32 or bf16 through wgmma needs its own error budget).
//
// Design: one CTA per (lane group of LG lanes, LD block); the lane group is
// the fastest grid index, so all lane groups of a block run together and
// read its diagonal tile from L2. Each int8 element a thread loads feeds all
// the lanes it owns. Every lane's arithmetic is the same whatever S, its
// lane group or its position in the group: fixed per-lane summation orders,
// and the rows skipped because every lane's change is exactly zero add
// exactly nothing to any lane. So sweeping a subset of the lanes (lane
// compaction) gives those lanes' results bit for bit. No atomics.
// Transcendentals are the exact expf/logf/log1pf (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

constexpr int T = 128;           // tile width: coordinates updated jointly
constexpr int LG = 8;            // lanes per CTA (one lane group)
constexpr int HALF = LG / 2;     // lanes per thread in the inner steps
constexpr int THREADS = 2 * T;   // (coordinate, half of the group) owners
constexpr float ETA_DIFF_EPS = 1e-8f;
static_assert(HALF == 4, "a thread's lanes travel as one float4");

__device__ __forceinline__ float sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ size_t lane_off(int s, int b, int NB, int B) {
    return (static_cast<size_t>(s) * NB + b) * B;
}

// One CTA per (lane group g, LD block b). State tensors are (S, NB, B)
// float32; hyper is (5, S): [sigma_eps, tau_beta, pi, active, lambda_min].
// A block with blk_mask[b] == 0, or a group whose lanes all have
// active == 0, is copied through bit-exactly with a zero eta change.
// Otherwise, per tile of T coordinates: thread (j, h) owns coordinate j of
// the lanes h*HALF .. h*HALF+HALF-1 of the group and takes their
// inner_steps gamma-weighted under-relaxed Jacobi steps against the (T, T)
// tile, dequantized once into shared memory as exact floats (one shared
// load of R feeds HALF lanes); the
// keep gate drops |d_eta| < 1e-8; then every thread applies the rank-T
// update q[l, :] += scale * d[l, :] R[tile rows, :] to four columns of all
// LG lanes (one global char4 load feeds LG lanes), skipping rows where
// every lane's change is exactly zero.
__global__ void __launch_bounds__(THREADS)
cavi_block_sweep_s(const int8_t* __restrict__ diag,
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
                   int S, int NB, int B, float scale, int inner_steps) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);            // (LG, B)
    float* v_s = q_s + LG * B;                              // (T, LG)
    float* R_s = v_s + T * LG;                              // (T, T)

    const int g = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int s0 = g * LG;
    const int nl = min(LG, S - s0);

    bool any_on = false;
    for (int l = 0; l < nl; ++l) any_on |= hyper[3 * S + s0 + l] > 0.0f;
    if (!blk_mask[b] || !any_on) {
        for (int l = 0; l < nl; ++l) {
            const size_t off = lane_off(s0 + l, b, NB, B);
            for (int j = tid; j < B; j += THREADS) {
                logits_out[off + j] = logits_in[off + j];
                mu_out[off + j] = mu_in[off + j];
                eta_out[off + j] = eta_in[off + j];
                q_out[off + j] = q_in[off + j];
                eta_diff[off + j] = 0.0f;
            }
        }
        return;
    }

    const int j = tid & (T - 1);   // coordinate within the tile
    const int h = tid / T;         // which half of the lane group
    float sig_e[HALF], tau_b[HALF], act[HALF], on[HALF], lam[HALF];
    float base_logit[HALF];
    bool valid[HALF];
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
        const int l = h * HALF + i;
        valid[i] = l < nl;
        const int s = s0 + l;
        // missing lanes of the last group: inert values, never written
        sig_e[i] = valid[i] ? hyper[s] : 1.0f;
        tau_b[i] = valid[i] ? hyper[S + s] : 1.0f;
        const float pi = valid[i] ? hyper[2 * S + s] : 0.5f;
        act[i] = valid[i] ? hyper[3 * S + s] : 0.0f;
        lam[i] = valid[i] ? hyper[4 * S + s] : 0.0f;
        on[i] = act[i] > 0.0f ? 1.0f : 0.0f;
        base_logit[i] = logf(pi) - log1pf(-pi) + 0.5f * logf(tau_b[i]);
    }

    for (int l = 0; l < LG; ++l) {
        const size_t off = lane_off(s0 + l, b, NB, B);
        for (int c = tid; c < B; c += THREADS)
            q_s[l * B + c] = l < nl ? q_in[off + c] : 0.0f;
    }

    const int8_t* D = diag + static_cast<size_t>(b) * B * B;
    for (int t0 = 0; t0 < B; t0 += T) {
        for (int w = tid; w < T * T / 4; w += THREADS) {
            const int r = w / (T / 4), c4 = w % (T / 4);
            reinterpret_cast<float4*>(R_s)[w] = i8x4_to_f32(
                *reinterpret_cast<const int*>(
                    D + static_cast<size_t>(t0 + r) * B + t0 + 4 * c4));
        }
        __syncthreads();   // R_s loaded; q_s updates of the last tile done

        const size_t jb = static_cast<size_t>(b) * B + t0 + j;
        const float n_j = nn[jb], beta_j = beta[jb], mask_j = mask[jb];
        const float rdiag = fabsf(R_s[j * T + j]) * scale;
        float vt[HALF], mm[HALF], logvt[HALF];
        float logit0[HALF], mu0[HALF], eta0[HALF];
        float q_cur[HALF], g_cur[HALF], mu_cur[HALF], eta_cur[HALF];
        float g_star[HALF], mu_star[HALF], c[HALF], d[HALF];
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
            const int l = h * HALF + i;
            vt[i] = n_j * (1.0f + lam[i]) / sig_e[i] + tau_b[i];
            mm[i] = n_j / (vt[i] * sig_e[i]);
            logvt[i] = logf(vt[i]);
            const size_t jj = lane_off(s0 + l, b, NB, B) + t0 + j;
            logit0[i] = valid[i] ? logits_in[jj] : 0.0f;
            mu0[i] = valid[i] ? mu_in[jj] : 0.0f;
            eta0[i] = valid[i] ? eta_in[jj] : 0.0f;
            q_cur[i] = q_s[l * B + t0 + j];
            g_cur[i] = sigmoid(logit0[i]);
            mu_cur[i] = mu0[i];
            eta_cur[i] = eta0[i];
        }
        float4* my_v = reinterpret_cast<float4*>(v_s + j * LG + h * HALF);

        for (int step = 0; step < inner_steps; ++step) {
#pragma unroll
            for (int i = 0; i < HALF; ++i) {
                mu_star[i] = mm[i] * (beta_j - q_cur[i]);
                const float u = base_logit[i] - 0.5f * logvt[i]
                    + 0.5f * vt[i] * mu_star[i] * mu_star[i];
                g_star[i] = sigmoid(u);
                c[i] = g_star[i] * fabsf(mm[i]);
            }
            *my_v = make_float4(c[0], c[1], c[2], c[3]);
            __syncthreads();
            // relaxation: sum_k c_k |R_kj|, minus the unit diagonal term
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
                g_cur[i] = g_cur[i] + w * (g_star[i] - g_cur[i]);
                mu_cur[i] = mu_cur[i] + w * (mu_star[i] - mu_cur[i]);
                d[i] = (g_cur[i] * mu_cur[i] - eta_cur[i]) * mask_j * on[i];
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
            float d_t = (eta_cur[i] - eta0[i]) * mask_j * on[i];
            const bool keep = fabsf(d_t) >= ETA_DIFF_EPS;
            d_t = keep ? d_t : 0.0f;
            d[i] = d_t;
            if (valid[i]) {
                const size_t jj = lane_off(s0 + h * HALF + i, b, NB, B) + t0 + j;
                const float u_new = logf(fmaxf(g_cur[i], 1e-30f))
                    - log1pf(-fminf(g_cur[i], 1.0f - 1e-7f));
                logits_out[jj] = keep ? u_new : logit0[i];
                mu_out[jj] = keep ? mu_cur[i] : mu0[i];
                const float eta_new = eta0[i] + d_t;
                eta_out[jj] = eta_new;
                eta_diff[jj] = eta_new - eta0[i];
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
    for (int l = 0; l < nl; ++l) {
        const size_t off = lane_off(s0 + l, b, NB, B);
        for (int c = tid; c < B; c += THREADS) q_out[off + c] = q_s[l * B + c];
    }
}

// One CTA per (lane group g, destination block b): q_out = q_in plus, for
// each coupling tile o incident to b in ascending o (the order of whole-tile
// additions of the sequential TPU pass) whose src or dst block is flagged:
//   b == src_o:  q[l, b] += scale * U_o   @ diff[l, dst_o]  (one warp per row)
//   b == dst_o:  q[l, b] += scale * U_o^T @ diff[l, src_o]  (4 columns a thread)
// for every lane l of the group; each int8 element loaded feeds LG lanes. A
// tile with both ends unflagged carries a zero diff and is skipped.
__global__ void __launch_bounds__(THREADS)
coupling_pass_s(const int8_t* __restrict__ off,
                const int* __restrict__ off_src,
                const int* __restrict__ off_dst,
                const int* __restrict__ inc_ptr,
                const int* __restrict__ inc_tile,
                const int* __restrict__ blk_mask,
                const float* __restrict__ q_in,
                const float* __restrict__ diff,
                float* __restrict__ q_out,
                int S, int NB, int B, float scale) {
    extern __shared__ __align__(16) float fsm[];
    float* q_s = fsm;            // (LG, B)
    float* v_s = fsm + LG * B;   // the other block's eta change: (LG, B)
                                 // for a row tile, (B, LG) for a column tile

    const int g = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int s0 = g * LG;
    const int nl = min(LG, S - s0);
    for (int l = 0; l < LG; ++l) {
        const size_t o = lane_off(s0 + l, b, NB, B);
        for (int c = tid; c < B; c += THREADS)
            q_s[l * B + c] = l < nl ? q_in[o + c] : 0.0f;
    }

    for (int p = inc_ptr[b]; p < inc_ptr[b + 1]; ++p) {
        const int o = inc_tile[p];
        const int s = off_src[o], d = off_dst[o];
        if (!blk_mask[s] && !blk_mask[d]) continue;
        const bool as_src = s == b;
        const int other = as_src ? d : s;
        __syncthreads();   // the previous tile is done with v_s and q_s
        for (int idx = tid; idx < LG * B; idx += THREADS) {
            const int l = idx / B, c = idx % B;
            const float v = l < nl ? diff[lane_off(s0 + l, other, NB, B) + c] : 0.0f;
            v_s[as_src ? idx : c * LG + l] = v;
        }
        __syncthreads();
        const int8_t* U = off + static_cast<size_t>(o) * B * B;
        if (as_src) {
            for (int i = warp; i < B; i += THREADS / 32) {
                const int8_t* row = U + static_cast<size_t>(i) * B;
                float acc[LG];
#pragma unroll
                for (int l = 0; l < LG; ++l) acc[l] = 0.f;
                for (int j4 = lane; j4 < B / 4; j4 += 32) {
                    const float4 u = i8x4_to_f32(
                        *reinterpret_cast<const int*>(row + 4 * j4));
#pragma unroll
                    for (int l = 0; l < LG; ++l) {
                        const float4 v = reinterpret_cast<const float4*>(
                            v_s + l * B)[j4];
                        acc[l] = fmaf(u.x, v.x, acc[l]);
                        acc[l] = fmaf(u.y, v.y, acc[l]);
                        acc[l] = fmaf(u.z, v.z, acc[l]);
                        acc[l] = fmaf(u.w, v.w, acc[l]);
                    }
                }
#pragma unroll
                for (int l = 0; l < LG; ++l) {
                    for (int sh = 16; sh > 0; sh >>= 1)
                        acc[l] += __shfl_down_sync(0xffffffffu, acc[l], sh);
                }
                if (lane == 0) {
#pragma unroll
                    for (int l = 0; l < LG; ++l) q_s[l * B + i] += acc[l] * scale;
                }
            }
        } else {
            for (int cg = tid; cg < B / 4; cg += THREADS) {
                float a[LG][4];
#pragma unroll
                for (int l = 0; l < LG; ++l)
                    a[l][0] = a[l][1] = a[l][2] = a[l][3] = 0.f;
                for (int i = 0; i < B; ++i) {
                    const float4 v0 = reinterpret_cast<const float4*>(v_s + i * LG)[0];
                    const float4 v1 = reinterpret_cast<const float4*>(v_s + i * LG)[1];
                    const float vi[LG] = {v0.x, v0.y, v0.z, v0.w,
                                          v1.x, v1.y, v1.z, v1.w};
                    bool any = false;
#pragma unroll
                    for (int l = 0; l < LG; ++l) any |= vi[l] != 0.0f;
                    if (any) {
                        const float4 r = i8x4_to_f32(*reinterpret_cast<const int*>(
                            U + static_cast<size_t>(i) * B + 4 * cg));
#pragma unroll
                        for (int l = 0; l < LG; ++l) {
                            a[l][0] = fmaf(vi[l], r.x, a[l][0]);
                            a[l][1] = fmaf(vi[l], r.y, a[l][1]);
                            a[l][2] = fmaf(vi[l], r.z, a[l][2]);
                            a[l][3] = fmaf(vi[l], r.w, a[l][3]);
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
        }
    }
    __syncthreads();
    for (int l = 0; l < nl; ++l) {
        const size_t o = lane_off(s0 + l, b, NB, B);
        for (int c = tid; c < B; c += THREADS) q_out[o + c] = q_s[l * B + c];
    }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

bool bad_shape(int S, int nb, int B) {
    return S < 0 || nb < 0 || nb > 65535 || B <= 0 || B % T != 0;
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); it never synchronizes. B must be a positive multiple of T.
int cavi_block_sweep_s_launch(const void* diag, const void* beta,
                              const void* nn, const void* mask,
                              const void* logits_in, const void* mu_in,
                              const void* eta_in, const void* q_in,
                              void* logits_out, void* mu_out, void* eta_out,
                              void* q_out, void* eta_diff,
                              const void* blk_mask, const void* hyper,
                              int S, int nb, int B, float scale,
                              int inner_steps, void* stream) {
    if (bad_shape(S, nb, B)) return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    const size_t smem = (LG * B + T * LG + T * T) * sizeof(float);
    cudaError_t err = set_smem(reinterpret_cast<const void*>(cavi_block_sweep_s), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + LG - 1) / LG, nb);
    cavi_block_sweep_s<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(diag), static_cast<const float*>(beta),
        static_cast<const float*>(nn), static_cast<const float*>(mask),
        static_cast<const float*>(logits_in), static_cast<const float*>(mu_in),
        static_cast<const float*>(eta_in), static_cast<const float*>(q_in),
        static_cast<float*>(logits_out), static_cast<float*>(mu_out),
        static_cast<float*>(eta_out), static_cast<float*>(q_out),
        static_cast<float*>(eta_diff), static_cast<const int*>(blk_mask),
        static_cast<const float*>(hyper), S, nb, B, scale, inner_steps);
    return static_cast<int>(cudaGetLastError());
}

int coupling_pass_s_launch(const void* off, const void* off_src,
                           const void* off_dst, const void* inc_ptr,
                           const void* inc_tile, const void* blk_mask,
                           const void* q_in, const void* eta_diff,
                           void* q_out, int S, int nb, int B, float scale,
                           void* stream) {
    if (bad_shape(S, nb, B)) return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    const size_t smem = 2 * LG * B * sizeof(float);
    cudaError_t err = set_smem(reinterpret_cast<const void*>(coupling_pass_s), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + LG - 1) / LG, nb);
    coupling_pass_s<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(off), static_cast<const int*>(off_src),
        static_cast<const int*>(off_dst), static_cast<const int*>(inc_ptr),
        static_cast<const int*>(inc_tile), static_cast<const int*>(blk_mask),
        static_cast<const float*>(q_in), static_cast<const float*>(eta_diff),
        static_cast<float*>(q_out), S, nb, B, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
