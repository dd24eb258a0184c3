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
// (L, KC) diff rows of lanes s0.. (zero past S) and the int8 U chunk, rows
// k (U[k0 + k][c0 ..], b the tile's destination) or columns k
// (U[c0 + c][k0 ..], b its source).
template <int L, int NT>
__device__ __forceinline__ void stage_chunk(
    const Cursor& c, float* a, int8_t* u, const int8_t* __restrict__ off,
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
    const int8_t* U = off + static_cast<size_t>(c.o) * B * B;
    const bool as_src = c.as_src();
#pragma unroll
    for (int j = 0; j < (KC * CC / 16 + NT - 1) / NT; ++j) {
        const int i = threadIdx.x + j * NT;
        if (i < KC * CC / 16) {
            if (as_src) {
                const int r = i / (KC / 16), part = i % (KC / 16);
                cp_async16(u + r * SST + 16 * part,
                           U + static_cast<size_t>(c0 + r) * B + k0 + 16 * part,
                           true);
            } else {
                const int r = i / (CC / 16), part = i % (CC / 16);
                cp_async16(u + r * CC + 16 * part,
                           U + static_cast<size_t>(k0 + r) * B + c0 + 16 * part,
                           true);
            }
        }
    }
}

// A staged int8 chunk as exact floats W[k][c] (KC, CC): U's rows as they
// are, or its columns transposed, so that both orientations feed one loop.
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
// lanes, b, its slab].
template <int LT, int TY>
__global__ void __launch_bounds__(TX * TY, 2)
coupling_pass_s(const int8_t* __restrict__ off,
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
    int8_t* u_s = reinterpret_cast<int8_t*>(w_s + 2 * KC * CC);  // STAGES x RAW

    const int entry = slabs[blockIdx.x];
    const int b = entry / (B / CC);
    const int c0 = entry % (B / CC) * CC;
    const int s0 = blockIdx.y * L;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    const TileWalk walk{inc_tile, off_src, off_dst, blk_mask, off_nz, b,
                        inc_ptr[b + 1], B / KC, B / 32, c0 / 32};

    // chunk n of the walk goes to ring stage n % STAGES and W buffer n % 2;
    // one cursor stages chunks STAGES - 1 = 2 ahead of the product, and each
    // is converted into W one iteration before its product. Bit n % STAGES
    // of `srcs` / `ends` says whether staged chunk n is of a tile that b is
    // the source of / the last chunk of its tile.
    Cursor cl = walk.at(inc_ptr[b]);
    int staged = 0;
    unsigned srcs = 0u, ends = 0u;
    auto stage = [&]() {
        const int st = staged % STAGES;
        stage_chunk<L, NT>(cl, a_s + st * L * AST, u_s + st * RAW, off, diff,
                           c0, s0, S, NB, B);
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
                              u_s + ((n + 1) % STAGES) * RAW,
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

template <int LT, int TY>
cudaError_t launch_coupling(const void* off, const void* off_src,
                            const void* off_dst, const void* inc_ptr,
                            const void* inc_tile, const void* blk_mask,
                            const void* off_nz, const void* slabs,
                            int n_slabs, const void* diff,
                            void* q, int S, int nb, int B, float scale,
                            cudaStream_t stream) {
    constexpr int L = LT * TY;
    const size_t smem = (STAGES * L * AST + 2 * KC * CC) * sizeof(float)
        + STAGES * RAW;
    cudaError_t err = set_smem(
        reinterpret_cast<const void*>(coupling_pass_s<LT, TY>), smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_slabs, (S + L - 1) / L);
    coupling_pass_s<LT, TY><<<grid, TX * TY, smem, stream>>>(
        static_cast<const int8_t*>(off), static_cast<const int*>(off_src),
        static_cast<const int*>(off_dst), static_cast<const int*>(inc_ptr),
        static_cast<const int*>(inc_tile), static_cast<const int*>(blk_mask),
        static_cast<const uint8_t*>(off_nz), static_cast<const int*>(slabs),
        static_cast<const float*>(diff), static_cast<float*>(q), S, nb, B,
        scale);
    return cudaGetLastError();
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

// coupling_pass_s in place on q for the (block, slab) entries
// slabs[0 .. n_slabs), with the lane tile L, one of the kernel's instances:
// 4, 16, 32 or 100 lanes.
int coupling_pass_s_launch(const void* off, const void* off_src,
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
    case 4: err = launch_coupling<1, 4>(COUPLING_ARGS); break;
    case 16: err = launch_coupling<4, 4>(COUPLING_ARGS); break;
    case 32: err = launch_coupling<4, 8>(COUPLING_ARGS); break;
    case 100: err = launch_coupling<5, 20>(COUPLING_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef COUPLING_ARGS
    return static_cast<int>(err);
}

}  // extern "C"
