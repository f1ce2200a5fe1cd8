// A host emulation of the CUDA built-ins that bzip3_tpu_torch/csrc/
// cm_kernels.cu uses, so that tests/test_torch_cm_emulated.py can run the
// kernels' own source on the CPU: one std::thread per CUDA thread, blocks
// one after another, shared memory one static buffer, __syncthreads,
// __syncwarp and the named barriers (bar.sync / bar.arrive with a thread
// count) as counting barriers.  A barrier whose count differs between
// arrivals, or that waits for 20 s, aborts the process.
#pragma once
#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __launch_bounds__(x)
#define __align__(x)

struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
struct dim3i { uint32_t x; };
extern thread_local dim3i threadIdx, blockIdx;
extern dim3i blockDim;
typedef int cudaError_t;
typedef void *cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 1 };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char *cudaGetErrorString(cudaError_t) { return ""; }

inline uint32_t __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline uint32_t __funnelshift_lc(uint32_t lo, uint32_t hi, uint32_t s) {
    s = s > 32 ? 32 : s;
    return (uint32_t)((((uint64_t)hi << 32 | lo) << s) >> 32);
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
    return (uint32_t)((((uint64_t)hi << 32 | lo) << (s & 31)) >> 32);
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint32_t __byte_perm(uint32_t x, uint32_t, uint32_t s) {
    if (s != 0x0123) abort();  // only the byte swap is emulated
    return __builtin_bswap32(x);
}
template <class T> T __ldg(const T *p) { return *p; }
using std::max;
using std::min;

struct EmuBarrier {
    std::mutex mu;
    std::condition_variable cv;
    int arrived = 0, expect = -1;
    long gen = 0;
    void arrive(int count, bool wait) {
        std::unique_lock<std::mutex> lk(mu);
        if (expect >= 0 && expect != count) {
            fprintf(stderr, "emu: barrier count %d, expected %d\n", count, expect);
            abort();
        }
        expect = count;
        const long g = gen;
        if (++arrived == count) {
            arrived = 0;
            expect = -1;
            ++gen;
            cv.notify_all();
            return;
        }
        if (wait && !cv.wait_for(lk, std::chrono::seconds(20), [&] { return gen != g; })) {
            fprintf(stderr, "emu: barrier deadlock\n");
            abort();
        }
    }
};
extern EmuBarrier emu_bars[16], emu_warps[32];
inline void emu_bar(int id, int count, bool wait) { emu_bars[id].arrive(count, wait); }
inline void __syncthreads() { emu_bar(0, blockDim.x, true); }
inline void __syncwarp() { emu_warps[threadIdx.x >> 5].arrive(32, true); }

// Runs body as `rows` blocks of blockDim.x threads, one block at a time.
inline void emu_launch(int rows, const std::function<void()> &body) {
    for (int r = 0; r < rows; ++r) {
        std::vector<std::thread> ts;
        for (uint32_t t = 0; t < blockDim.x; ++t)
            ts.emplace_back([&body, r, t] {
                threadIdx.x = t;
                blockIdx.x = (uint32_t)r;
                body();
            });
        for (auto &t : ts) t.join();
    }
}
