// Hopper (sm_90a) CUDA kernels for the single-model (S = 1) blocked CAVI
// sweep of VIPRS, with a plain C interface for ctypes (ops/_build.py).
//
// cavi_block_sweep_s1 replaces the TPU kernels _sweep_kernel_s1 (all-active
// sweep, viprs_tpu/ops/cavi_pallas.py:133) and the first pass of _skip_kernel
// (active-block sweep, cavi_pallas.py:317); coupling_pass_s1 replaces the
// coupling pass _off_pass (cavi_pallas.py:492) and, with every block
// flagged, cavi_jax.refresh_q on the all-active branch. Their plain PyTorch
// versions are ops/cavi_torch.block_sweep and ops/cavi_torch.coupling_pass.
//
// What bounds them on the card: one read of the int8 LD per sweep (diagonal
// tiles 1.19 GB + coupling tiles 0.26 GB on the 1.1M-variant genome at
// B = 1024), against 3.35 TB/s of HBM. This first version is simple on
// purpose: one CTA per LD block, f32 FMAs on the CUDA cores (at S = 1 every
// product is a matvec, so tensor cores have nothing to reuse), int8 rows
// read straight from global memory with 4-byte coalesced loads, and no
// atomics, so every result is deterministic. Transcendentals are the exact
// expf/logf/log1pf (no fast math), as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;          // tile width: coordinates updated jointly
constexpr int THREADS = 256;    // B / 4 int8 column groups at B = 1024
constexpr float ETA_DIFF_EPS = 1e-8f;

__device__ __forceinline__ float sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// One CTA per LD block b. A block with blk_mask[b] == 0 is copied through
// bit-exactly with a zero eta change. Otherwise, for each tile t of T
// coordinates: the (T, T) int8 diagonal tile goes to shared memory, threads
// 0..T-1 (one per coordinate) take inner_steps gamma-weighted under-relaxed
// Jacobi steps from a tile-locally refreshed q, the keep gate drops
// |d_eta| < 1e-8, and all threads apply the rank-T update
// q[:] += scale * d_t^T R[tile rows, :] to the block's q in shared memory
// (skipping rows whose d_k is exactly zero: a uniform branch, exact).
//
// hyper: [sigma_eps, tau_beta, pi, active, lambda_min] float32 on the device.
__global__ void __launch_bounds__(THREADS)
cavi_block_sweep_s1(const int8_t* __restrict__ diag,
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
    float* q_s = reinterpret_cast<float*>(smem);           // (B,)
    float* v_s = q_s + B;                                  // (T,) c or d
    int8_t* R_s = reinterpret_cast<int8_t*>(v_s + T);      // (T, T)

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const size_t off = static_cast<size_t>(b) * B;

    if (!blk_mask[b]) {
        for (int j = tid; j < B; j += THREADS) {
            logits_out[off + j] = logits_in[off + j];
            mu_out[off + j] = mu_in[off + j];
            eta_out[off + j] = eta_in[off + j];
            q_out[off + j] = q_in[off + j];
            eta_diff[off + j] = 0.0f;
        }
        return;
    }

    const float sig_e = hyper[0], tau_b = hyper[1], pi = hyper[2];
    const float act = hyper[3], lam = hyper[4];
    const float on = act > 0.0f ? 1.0f : 0.0f;
    const float base_logit = logf(pi) - log1pf(-pi) + 0.5f * logf(tau_b);

    for (int j = tid; j < B; j += THREADS) q_s[j] = q_in[off + j];

    const int8_t* D = diag + static_cast<size_t>(b) * B * B;
    const bool owner = tid < T;
    for (int t0 = 0; t0 < B; t0 += T) {
        for (int w = tid; w < T * T / 4; w += THREADS) {
            const int r = w / (T / 4), c4 = w % (T / 4);
            reinterpret_cast<int*>(R_s)[w] = *reinterpret_cast<const int*>(
                D + static_cast<size_t>(t0 + r) * B + t0 + 4 * c4);
        }
        __syncthreads();   // R_s loaded; q_s updates of the last tile done

        const size_t jj = off + t0 + tid;
        float n_j = 0.f, beta_j = 0.f, mask_j = 0.f, vt = 1.f, mm = 0.f;
        float logvt = 0.f, logit0 = 0.f, mu0 = 0.f, eta0 = 0.f, rdiag = 0.f;
        float q_cur = 0.f, g_cur = 0.f, mu_cur = 0.f, eta_cur = 0.f;
        if (owner) {
            n_j = nn[jj];
            beta_j = beta[jj];
            mask_j = mask[jj];
            vt = n_j * (1.0f + lam) / sig_e + tau_b;
            mm = n_j / (vt * sig_e);
            logvt = logf(vt);
            logit0 = logits_in[jj];
            mu0 = mu_in[jj];
            eta0 = eta_in[jj];
            rdiag = fabsf(static_cast<float>(R_s[tid * T + tid])) * scale;
            q_cur = q_s[t0 + tid];
            g_cur = sigmoid(logit0);
            mu_cur = mu0;
            eta_cur = eta0;
        }

        for (int step = 0; step < inner_steps; ++step) {
            float mu_star = 0.f, g_star = 0.f, c = 0.f, d_in = 0.f;
            if (owner) {
                mu_star = mm * (beta_j - q_cur);
                const float u = base_logit - 0.5f * logvt
                    + 0.5f * vt * mu_star * mu_star;
                g_star = sigmoid(u);
                c = g_star * fabsf(mm);
                v_s[tid] = c;
            }
            __syncthreads();
            if (owner) {
                // relaxation: sum_k c_k |R_kj|, minus the unit diagonal term
                float acc = 0.f;
                for (int k = 0; k < T; ++k)
                    acc = fmaf(v_s[k], fabsf(static_cast<float>(R_s[k * T + tid])), acc);
                const float w = act / (1.0f + (acc * scale - rdiag * c));
                g_cur = g_cur + w * (g_star - g_cur);
                mu_cur = mu_cur + w * (mu_star - mu_cur);
                d_in = (g_cur * mu_cur - eta_cur) * mask_j * on;
            }
            __syncthreads();
            if (owner) v_s[tid] = d_in;
            __syncthreads();
            if (owner) {
                // tile-local q refresh: sum_k d_k R_kj - d_j
                float acc = 0.f;
                for (int k = 0; k < T; ++k)
                    acc = fmaf(v_s[k], static_cast<float>(R_s[k * T + tid]), acc);
                q_cur = q_cur + acc * scale - d_in;
                eta_cur = eta_cur + d_in;
            }
            __syncthreads();
        }

        if (owner) {
            float d_t = (eta_cur - eta0) * mask_j * on;
            const bool keep = fabsf(d_t) >= ETA_DIFF_EPS;
            d_t = keep ? d_t : 0.0f;
            const float u_new = logf(fmaxf(g_cur, 1e-30f))
                - log1pf(-fminf(g_cur, 1.0f - 1e-7f));
            logits_out[jj] = keep ? u_new : logit0;
            mu_out[jj] = keep ? mu_cur : mu0;
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
                    const char4 r = *reinterpret_cast<const char4*>(
                        rows + static_cast<size_t>(k) * B + 4 * cg);
                    a0 = fmaf(dk, static_cast<float>(r.x), a0);
                    a1 = fmaf(dk, static_cast<float>(r.y), a1);
                    a2 = fmaf(dk, static_cast<float>(r.z), a2);
                    a3 = fmaf(dk, static_cast<float>(r.w), a3);
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

// One CTA per destination block b: q_out[b] = q_in[b] plus, for each
// coupling tile o incident to b in ascending o (the order in which the
// sequential TPU pass adds whole tile contributions) whose src or dst block
// is flagged in blk_mask:
//   b == src_o:  q[b] += scale * U_o   @ diff[dst_o]   (one warp per row)
//   b == dst_o:  q[b] += scale * U_o^T @ diff[src_o]   (4 columns a thread)
// A tile with both ends unflagged carries a zero diff and is skipped.
__global__ void __launch_bounds__(THREADS)
coupling_pass_s1(const int8_t* __restrict__ off,
                 const int* __restrict__ off_src,
                 const int* __restrict__ off_dst,
                 const int* __restrict__ inc_ptr,
                 const int* __restrict__ inc_tile,
                 const int* __restrict__ blk_mask,
                 const float* __restrict__ q_in,
                 const float* __restrict__ diff,
                 float* __restrict__ q_out,
                 int B, float scale) {
    extern __shared__ __align__(16) float fsm[];
    float* q_s = fsm;        // (B,)
    float* v_s = fsm + B;    // (B,) the other block's eta change

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const size_t boff = static_cast<size_t>(b) * B;
    for (int j = tid; j < B; j += THREADS) q_s[j] = q_in[boff + j];

    for (int p = inc_ptr[b]; p < inc_ptr[b + 1]; ++p) {
        const int o = inc_tile[p];
        const int s = off_src[o], d = off_dst[o];
        if (!blk_mask[s] && !blk_mask[d]) continue;
        const int other = (s == b) ? d : s;
        __syncthreads();   // the previous tile is done with v_s and q_s
        for (int j = tid; j < B; j += THREADS)
            v_s[j] = diff[static_cast<size_t>(other) * B + j];
        __syncthreads();
        const int8_t* U = off + static_cast<size_t>(o) * B * B;
        if (s == b) {
            for (int i = warp; i < B; i += THREADS / 32) {
                const int8_t* row = U + static_cast<size_t>(i) * B;
                float acc = 0.f;
                for (int j4 = lane; j4 < B / 4; j4 += 32) {
                    const char4 r = *reinterpret_cast<const char4*>(row + 4 * j4);
                    acc = fmaf(static_cast<float>(r.x), v_s[4 * j4 + 0], acc);
                    acc = fmaf(static_cast<float>(r.y), v_s[4 * j4 + 1], acc);
                    acc = fmaf(static_cast<float>(r.z), v_s[4 * j4 + 2], acc);
                    acc = fmaf(static_cast<float>(r.w), v_s[4 * j4 + 3], acc);
                }
                for (int sh = 16; sh > 0; sh >>= 1)
                    acc += __shfl_down_sync(0xffffffffu, acc, sh);
                if (lane == 0) q_s[i] += acc * scale;
            }
        } else {
            for (int cg = tid; cg < B / 4; cg += THREADS) {
                float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
                for (int i = 0; i < B; ++i) {
                    const float vi = v_s[i];
                    if (vi != 0.0f) {
                        const char4 r = *reinterpret_cast<const char4*>(
                            U + static_cast<size_t>(i) * B + 4 * cg);
                        a0 = fmaf(vi, static_cast<float>(r.x), a0);
                        a1 = fmaf(vi, static_cast<float>(r.y), a1);
                        a2 = fmaf(vi, static_cast<float>(r.z), a2);
                        a3 = fmaf(vi, static_cast<float>(r.w), a3);
                    }
                }
                q_s[4 * cg + 0] += a0 * scale;
                q_s[4 * cg + 1] += a1 * scale;
                q_s[4 * cg + 2] += a2 * scale;
                q_s[4 * cg + 3] += a3 * scale;
            }
        }
    }
    __syncthreads();
    for (int j = tid; j < B; j += THREADS) q_out[boff + j] = q_s[j];
}

cudaError_t set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); it never synchronizes. B must be a positive multiple of T.
int cavi_block_sweep_s1_launch(const void* diag, const void* beta,
                               const void* nn, const void* mask,
                               const void* logits_in, const void* mu_in,
                               const void* eta_in, const void* q_in,
                               void* logits_out, void* mu_out, void* eta_out,
                               void* q_out, void* eta_diff,
                               const void* blk_mask, const void* hyper,
                               int nb, int B, float scale, int inner_steps,
                               void* stream) {
    if (B <= 0 || B % T != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0) return static_cast<int>(cudaGetLastError());
    const size_t smem = (B + T) * sizeof(float) + T * T;
    cudaError_t err = set_smem(reinterpret_cast<const void*>(cavi_block_sweep_s1), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cavi_block_sweep_s1<<<nb, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(diag), static_cast<const float*>(beta),
        static_cast<const float*>(nn), static_cast<const float*>(mask),
        static_cast<const float*>(logits_in), static_cast<const float*>(mu_in),
        static_cast<const float*>(eta_in), static_cast<const float*>(q_in),
        static_cast<float*>(logits_out), static_cast<float*>(mu_out),
        static_cast<float*>(eta_out), static_cast<float*>(q_out),
        static_cast<float*>(eta_diff), static_cast<const int*>(blk_mask),
        static_cast<const float*>(hyper), B, scale, inner_steps);
    return static_cast<int>(cudaGetLastError());
}

int coupling_pass_s1_launch(const void* off, const void* off_src,
                            const void* off_dst, const void* inc_ptr,
                            const void* inc_tile, const void* blk_mask,
                            const void* q_in, const void* eta_diff,
                            void* q_out, int nb, int B, float scale,
                            void* stream) {
    if (B <= 0 || B % T != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0) return static_cast<int>(cudaGetLastError());
    const size_t smem = 2 * B * sizeof(float);
    cudaError_t err = set_smem(reinterpret_cast<const void*>(coupling_pass_s1), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    coupling_pass_s1<<<nb, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(off), static_cast<const int*>(off_src),
        static_cast<const int*>(off_dst), static_cast<const int*>(inc_ptr),
        static_cast<const int*>(inc_tile), static_cast<const int*>(blk_mask),
        static_cast<const float*>(q_in), static_cast<const float*>(eta_diff),
        static_cast<float*>(q_out), B, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
