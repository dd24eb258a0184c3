// Hopper (sm_90a) CUDA kernel instances: cavi_block_sweep_mix_s (K7/K8,
// mix_lane.cuh) on float32 (dequantized) LD tiles, with a plain C interface
// for ctypes (ops/_build.py). Its int8 instances are in cavi_mix.cu; these
// have a translation unit of their own so that nvcc builds both halves side
// by side.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_lane.cuh"

namespace {

// the float32 instances of cavi_block_sweep_mix_s
template <int K> struct SLF { static cudaError_t run(const Args& a) { return launch_lanes<K, float>(a); } };

}  // namespace

extern "C" {

// cavi_block_sweep_mix_s on float32 tiles (scale 1) with the lane tile L: 4,
// or 8 or 20 for K <= 3; enqueued on `stream`, returning cudaGetLastError()
// (0 on success), never synchronizing. B must be a positive multiple of T
// and 1 <= K <= 8. The state tensors, the tiles and diag_nz must be 16-byte
// aligned.
int cavi_block_sweep_mix_s_f32_launch(const void* diag, const void* diag_nz,
                                      const void* beta, const void* nn,
                                      const void* mask, const void* gamma_in,
                                      const void* mu_in, const void* eta_in,
                                      const void* q_in, void* gamma_out,
                                      void* mu_out, void* eta_out,
                                      void* q_out, void* eta_diff,
                                      const void* blk_mask,
                                      const void* hyper, int S, int K, int nb,
                                      int B, float scale, int inner_steps,
                                      int unit_diag, int L, void* stream) {
    if (bad_shape(S, K, nb, B) || inner_steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(by_k<SLF>(K, make_args(
        diag, diag_nz, beta, nn, mask, gamma_in, mu_in, eta_in, q_in,
        gamma_out, mu_out, eta_out, q_out, eta_diff, blk_mask, hyper, S, nb,
        B, scale, inner_steps, unit_diag, L, stream)));
}

}  // extern "C"
