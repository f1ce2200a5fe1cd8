// Dependent-chain latencies on the card, one thread, not part of the
// port: the instructions on the CM coders' bit step, in SM cycles
// (clock64; `sm_latency`, built and run by scripts/torch_cm_sass.py), and
// for the LZP kernels (built and run by chip_smoke.py): the round trip of
// a load from device memory (`sm_chase`, a pointer chase over a table of
// the caller's size, through L2 and past L1) and a warp's dependent
// __match_any_sync (`sm_match_any`); and for P2, the range coder's bit
// step alone (`sm_coder_chain`, built and run by chip_smoke.py).
//
// Each chain runs kReps dependent steps unrolled; out[k] gets the cycles
// of chain k over kReps, out[kChains] a value that keeps the chains live.

#include <cstdint>
#include <cuda_runtime.h>

#include "../bzip3_tpu_torch/csrc/cm_coder.cuh"  // split_hi, renorm_shift, renorm

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

// steps dependent loads j = next[j] from j = start, past L1 (ld.global.cg):
// out[0] the clock64 cycles, out[1] the last j (keeps the chain live).
__global__ void chase_kernel(const uint32_t *next, int64_t steps, uint32_t start,
                             long long *out) {
    uint32_t j = start;
    const long long t0 = clock64();
    for (int64_t k = 0; k < steps; ++k) j = __ldcg(next + j);
    out[0] = clock64() - t0;
    out[1] = j;
}

// One warp, kReps dependent __match_any_sync: out[0] the cycles with 32
// distinct values, out[1] with 32 equal ones, out[2] keeps both live.
__global__ void match_kernel(long long *out, uint32_t seed) {
    const uint32_t lane = threadIdx.x & 31u;
    uint32_t v = seed + lane * 0x9E3779B1u, w = seed;
    long long t0 = clock64();
    for (int k = 0; k < kReps; ++k) v += __match_any_sync(0xFFFFFFFFu, v) - (1u << lane);
    long long t1 = clock64();
    out[0] = t1 - t0;
    t0 = clock64();
    for (int k = 0; k < kReps; ++k) w += ~__match_any_sync(0xFFFFFFFFu, w);
    t1 = clock64();
    out[1] = t1 - t0;
    if (lane == 0) out[2] = v + w;
}

// The range coder's dependent chain of a bit step, as P2's loop runs it
// (cm_parallel_kernels.cu): the split, the select on the bit, the renorm
// count and shifts, over `steps` bits (a multiple of 64).  The split
// factors and bits come from a hash of the step's index, off the chain,
// and nothing is stored, so a step takes the chain's latency alone:
// out[0] the clock64 cycles, out[1] keeps the chain live.
__global__ void coder_chain_kernel(int64_t steps, uint32_t seed, long long *out) {
    uint32_t low = 0, high = 0xFFFFFFFFu, shifted = 0;
    const long long t0 = clock64();
    for (int64_t k = 0; k < steps; k += 64) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            const uint32_t w = ((uint32_t)k + i) * 0x9E3779B1u + seed;
            const uint32_t step = split_hi(low, high, (w & 0x3FFFFu) << 14);
            if (w >> 31)
                high = low + step;
            else
                low = low + step + 1;
            const uint32_t sh = renorm_shift(low, high);
            shifted += sh;
            renorm(low, high, sh);
        }
    }
    out[0] = clock64() - t0;
    out[1] = (long long)(low ^ high) + shifted;
}

}  // namespace

extern "C" int sm_coder_chain(int64_t steps, uint32_t seed, long long *out, void *stream) {
    coder_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(steps, seed, out);
    return (int)cudaGetLastError();
}

extern "C" int sm_match_any(long long *out, uint32_t seed, void *stream) {
    match_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(out, seed);
    return (int)cudaGetLastError();
}

extern "C" int sm_chase(const uint32_t *next, int64_t steps, uint32_t start, long long *out,
                        void *stream) {
    chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, start, out);
    return (int)cudaGetLastError();
}

extern "C" int sm_latency(long long *out, uint32_t seed) {
    latency_kernel<<<1, 128>>>(out, seed);
    return (int)cudaGetLastError();
}

extern "C" int sm_latency_reps() { return kReps; }
