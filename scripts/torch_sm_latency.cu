// Dependent-chain latencies of the instructions on the CM coders' bit
// step, in SM cycles (clock64), one thread on the card.  Built and run by
// scripts/torch_cm_sass.py; not part of the port.
//
// Each chain runs kReps dependent steps unrolled; out[k] gets the cycles
// of chain k over kReps, out[kChains] a value that keeps the chains live.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kReps = 4096;
constexpr int kChains = 7;

__global__ void latency_kernel(long long *out, uint32_t seed) {
    __shared__ uint16_t sh[4096];
    for (int i = threadIdx.x; i < 4096; i += blockDim.x) sh[i] = (uint16_t)((i * 1031 + 7) & 4095);
    __syncthreads();
    if (threadIdx.x != 0) return;
    uint32_t j = seed & 4095, x = seed | 1, y = seed ^ 0x5bd1e995u;
    long long t0, t1;

    t0 = clock64();  // 0: LDS.U16, address from the value loaded
#pragma unroll 64
    for (int k = 0; k < kReps; ++k) j = sh[j];
    t1 = clock64();
    out[0] = t1 - t0;

    t0 = clock64();  // 1: IMAD
#pragma unroll 64
    for (int k = 0; k < kReps; ++k) x = x * 0x9E3779B1u + j;
    t1 = clock64();
    out[1] = t1 - t0;

    t0 = clock64();  // 2: the range split, IMAD.WIDE.U32 then SHF.R.U64
#pragma unroll 64
    for (int k = 0; k < kReps; ++k) x = (uint32_t)(((uint64_t)x * (y | 1u)) >> 18) + y;
    t1 = clock64();
    out[2] = t1 - t0;

    t0 = clock64();  // 3: the renorm count, FLO (clz) then LOP3
#pragma unroll 64
    for (int k = 0; k < kReps; ++k) x = (__clz(x) & 0x38u) ^ y ^ x;
    t1 = clock64();
    out[3] = t1 - t0;

    t0 = clock64();  // 4: the renorm shift, SHF (funnel, clamped)
#pragma unroll 64
    for (int k = 0; k < kReps; ++k) x = __funnelshift_lc(y, x, x & 31u);
    t1 = clock64();
    out[4] = t1 - t0;

    t0 = clock64();  // 5: compare and select (ISETP + SEL)
#pragma unroll 64
    for (int k = 0; k < kReps; ++k) x = x <= y ? x + 3u : x - 5u;
    t1 = clock64();
    out[5] = t1 - t0;

    t0 = clock64();  // 6: the split as a high product, IMAD.HI.U32 then IADD
#pragma unroll 64
    for (int k = 0; k < kReps; ++k) x = __umulhi(x, y << 14) + y;
    t1 = clock64();
    out[6] = t1 - t0;

    out[kChains] = (long long)(j + x);
}

}  // namespace

extern "C" int sm_latency(long long *out, uint32_t seed) {
    latency_kernel<<<1, 128>>>(out, seed);
    return (int)cudaGetLastError();
}

extern "C" int sm_latency_reps() { return kReps; }
