// The CM coder's register steps, shared by K1-K3c (cm_kernels.cu) and
// the parallel encoder's kernels P1/P2 (cm_parallel_kernels.cu): the
// counter update, the range split and the closed-form renorm.
// Semantics: src/libbz3.c:331-494.
#pragma once

#include <cstdint>

namespace {

// The range split (high - low) * scale >> 18 as one high product,
// umulhi(high - low, scale << 14), exact as scale < 2^18.  On an H100 a
// dependent IMAD.HI + IADD takes 9 cycles, IMAD.WIDE + SHF + IADD 23.
__device__ __forceinline__ uint32_t split_hi(uint32_t low, uint32_t high, uint32_t scale14) {
    return __umulhi(high - low, scale14);
}

// A 16-bit counter's step toward the bit at `rate` (2, 4 or 6).
__device__ __forceinline__ int adapt(int v, uint32_t bit, int rate) {
    return bit ? v + ((v ^ 65535) >> rate) : v - (v >> rate);
}

// The renorm after a bit in closed form: 8 times the bytes the
// reference's renorm loop (src/libbz3.c:331-494) shifts out.  It runs
// while the top byte of low ^ high is 0, and each turn shifts the next
// byte of low ^ high up (the bytes shifted in differ in every bit), so
// it takes the count of leading zero bytes: 4 when low == high.
__device__ __forceinline__ uint32_t renorm_shift(uint32_t low, uint32_t high) {
    return __clz(low ^ high) & 0x38u;
}

// low << sh and (high << sh) | (2^sh - 1) for sh in [0, 32].
__device__ __forceinline__ void renorm(uint32_t &low, uint32_t &high, uint32_t sh) {
    low = __funnelshift_lc(0u, low, sh);
    high = __funnelshift_lc(0xFFFFFFFFu, high, sh);
}

}  // namespace
