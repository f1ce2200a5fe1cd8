// A host emulation of the CUDA built-ins that bzip3_tpu_torch/csrc/
// cm_kernels.cu, lzp_kernels.cu and crc32_kernels.cu use, so that
// tests/test_torch_cm_emulated.py, test_torch_lzp_emulated.py and
// test_torch_crc32_emulated.py can run the kernels' own source on
// the CPU: one std::thread per CUDA thread, up to kEmuBlocks blocks at a
// time, each with its own shared memory and barriers; __syncthreads,
// __syncwarp and the named barriers (bar.sync / bar.arrive with a thread
// count) as counting barriers.  A barrier whose count differs between
// arrivals, or that waits for 20 s, aborts the process.  The warp
// collectives (__shfl_sync, __shfl_up_sync, __ballot_sync,
// __match_any_sync) take the full mask only: each lane posts its value
// in its warp's slots, the warp meets, each lane reads, the warp meets
// again (a yielding barrier of its own).  __ldg can be held to the
// ranges a kernel may read (emu_ldg_ranges).
#pragma once
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <memory>
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
struct dim3i { uint32_t x, y; };
extern thread_local dim3i threadIdx, blockIdx;
extern dim3i blockDim;
typedef int cudaError_t;
typedef void *cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 1 };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char *cudaGetErrorString(cudaError_t) { return ""; }

inline uint32_t __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline int __ffs(uint32_t x) { return __builtin_ffs((int)x); }
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
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
// Reads through __ldg may be held to ranges: while emu_ldg_ranges holds
// any, a read that is not wholly inside one of them is counted in
// emu_ldg_faults and gives zero instead of touching memory.  Empty (the
// CM and LZP tests), every read goes through.  These variables, like the
// other per-library state below, are static: an inline variable is one
// GNU-unique symbol shared by every emulation library a process loads, so
// one test's ranges would hold in the next test's library.
struct EmuRange { const char *lo, *hi; };
static std::vector<EmuRange> emu_ldg_ranges;
static std::atomic<long> emu_ldg_faults{0};
template <class T> T __ldg(const T *p) {
    if (!emu_ldg_ranges.empty()) {
        const char *a = reinterpret_cast<const char *>(p), *b = a + sizeof(T);
        bool inside = false;
        for (const EmuRange &r : emu_ldg_ranges) inside |= a >= r.lo && b <= r.hi;
        if (!inside) {
            emu_ldg_faults.fetch_add(1);
            return T{};
        }
    }
    return *p;
}
using std::max;
using std::min;

struct EmuBarrier {
    std::mutex mu;
    int arrived = 0, expect = -1;
    std::atomic<long> gen{0};
    void arrive(int count, bool wait) {
        long g;
        {
            std::lock_guard<std::mutex> lk(mu);
            if (expect >= 0 && expect != count) {
                fprintf(stderr, "emu: barrier count %d, expected %d\n", count, expect);
                abort();
            }
            expect = count;
            g = gen.load(std::memory_order_relaxed);
            if (++arrived == count) {
                arrived = 0;
                expect = -1;
                gen.store(g + 1, std::memory_order_release);
                return;
            }
        }
        if (!wait) return;
        // wait by yielding: a condition variable's wake-ups take each of
        // the block's threads through the mutex again, one at a time
        const auto t0 = std::chrono::steady_clock::now();
        for (long k = 1; gen.load(std::memory_order_acquire) == g; ++k) {
            std::this_thread::yield();
            if (k % 4096 == 0 && std::chrono::steady_clock::now() - t0 > std::chrono::seconds(20)) {
                fprintf(stderr, "emu: barrier deadlock\n");
                abort();
            }
        }
    }
};
// The warp collectives' barrier: a counter and a generation, waited on
// by yielding (collectives come a few a window, so a condition variable's
// wake-ups would dominate); 20 s of waiting aborts.
struct EmuSpin {
    std::atomic<int> arrived{0};
    std::atomic<long> gen{0};
    void arrive() {
        const long g = gen.load(std::memory_order_acquire);
        if (arrived.fetch_add(1, std::memory_order_acq_rel) == 31) {
            arrived.store(0, std::memory_order_relaxed);
            gen.fetch_add(1, std::memory_order_release);
            return;
        }
        const auto t0 = std::chrono::steady_clock::now();
        for (long k = 1; gen.load(std::memory_order_acquire) == g; ++k) {
            std::this_thread::yield();
            if (k % 4096 == 0 && std::chrono::steady_clock::now() - t0 > std::chrono::seconds(20)) {
                fprintf(stderr, "emu: warp collective deadlock\n");
                abort();
            }
        }
    }
};
// The block's shared memory (the kernels' `smem`) and barriers, set in
// each thread by emu_launch.
extern thread_local unsigned char *smem;
extern thread_local EmuBarrier *emu_bars, *emu_warps;
static thread_local EmuSpin *emu_spin;
inline void emu_bar(int id, int count, bool wait) { emu_bars[id].arrive(count, wait); }
inline void __syncthreads() { emu_bar(0, blockDim.x, true); }
// A block of one warp (the LZP kernels) meets on the warp collectives'
// yielding barrier, so that its lanes do not wait on two kinds.
inline void __syncwarp() {
    if (blockDim.x == 32)
        emu_spin->arrive();
    else
        emu_warps[threadIdx.x >> 5].arrive(32, true);
}

// The slots of the thread's warp (set by emu_launch).
static thread_local uint32_t *emu_slots;

inline uint32_t emu_lane() { return threadIdx.x & 31u; }
template <class F> inline uint32_t emu_collect(uint32_t mask, uint32_t v, F read) {
    if (mask != 0xFFFFFFFFu) {
        fprintf(stderr, "emu: warp collective with mask %08x\n", mask);
        abort();
    }
    emu_slots[emu_lane()] = v;
    emu_spin->arrive();
    const uint32_t r = read(emu_slots);
    emu_spin->arrive();
    return r;
}
template <class T> T __shfl_sync(uint32_t mask, T v, int src) {
    static_assert(sizeof(T) == 4, "32-bit shuffles only");
    return (T)emu_collect(mask, (uint32_t)v, [&](const uint32_t *s) { return s[src & 31]; });
}
template <class T> T __shfl_up_sync(uint32_t mask, T v, unsigned delta) {
    static_assert(sizeof(T) == 4, "32-bit shuffles only");
    const uint32_t l = emu_lane();
    return (T)emu_collect(mask, (uint32_t)v,
                          [&](const uint32_t *s) { return l >= delta ? s[l - delta] : s[l]; });
}
inline uint32_t __ballot_sync(uint32_t mask, bool pred) {
    return emu_collect(mask, pred ? 1u : 0u, [](const uint32_t *s) {
        uint32_t r = 0;
        for (int k = 0; k < 32; ++k) r |= s[k] << k;
        return r;
    });
}
inline uint32_t __match_any_sync(uint32_t mask, uint32_t v) {
    return emu_collect(mask, v, [&](const uint32_t *s) {
        uint32_t r = 0;
        for (int k = 0; k < 32; ++k) r |= (uint32_t)(s[k] == v) << k;
        return r;
    });
}

struct EmuBlock {
    alignas(16) unsigned char smem[232448];  // an H100 block's most
    EmuBarrier bars[16], warps[32];
    uint32_t slots[32][32];
    EmuSpin spins[32];
};
constexpr int kEmuBlocks = 4;

// Runs body as a grid of gx x gy blocks of blockDim.x threads, kEmuBlocks
// at a time (blockIdx.x varies fastest).
inline void emu_launch_grid(int gx, int gy, const std::function<void()> &body) {
    const int rows = gx * gy;
    for (int r0 = 0; r0 < rows; r0 += kEmuBlocks) {
        std::vector<std::unique_ptr<EmuBlock>> blocks;
        std::vector<std::thread> ts;
        for (int r = r0; r < std::min(rows, r0 + kEmuBlocks); ++r) {
            blocks.emplace_back(new EmuBlock());
            EmuBlock *b = blocks.back().get();
            for (uint32_t t = 0; t < blockDim.x; ++t)
                ts.emplace_back([&body, b, r, t, gx] {
                    threadIdx.x = t;
                    blockIdx.x = (uint32_t)(r % gx);
                    blockIdx.y = (uint32_t)(r / gx);
                    smem = b->smem;
                    emu_bars = b->bars;
                    emu_warps = b->warps;
                    emu_slots = b->slots[t >> 5];
                    emu_spin = &b->spins[t >> 5];
                    body();
                });
        }
        for (auto &t : ts) t.join();
    }
}

// Runs body as `rows` blocks (blockIdx.x = 0 .. rows - 1).
inline void emu_launch(int rows, const std::function<void()> &body) {
    emu_launch_grid(rows, 1, body);
}
