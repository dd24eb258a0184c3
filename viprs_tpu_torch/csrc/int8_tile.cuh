// Shared by the block-sweep kernels (cavi_s.cu, cavi_mix.cu): int8 LD words
// to exact floats.
#pragma once

#include <cuda_runtime.h>

// The four int8 values of a char4 word as exact floats, without the
// quarter-rate int-to-float conversion: each byte, offset by 128, becomes
// the low mantissa bits of 2^23 and the offset is subtracted again.
__device__ __forceinline__ float4 i8x4_to_f32(int w) {
    const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
    const float off = 8388736.0f;   // 2^23 + 128
    return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - off,
                       __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - off,
                       __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - off,
                       __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - off);
}

// One int8 value as an exact float: b + 1.5 * 2^23 lies in [2^23, 2^24),
// where a float's unit in the last place is 1.
__device__ __forceinline__ float i8_to_f32(int b) {
    return __int_as_float(0x4B400000 + b) - 12582912.0f;
}
