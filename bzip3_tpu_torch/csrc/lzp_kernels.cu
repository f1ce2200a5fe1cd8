// LZP pre-pass kernels for Hopper (sm_90a): K5 encode, K6 decode.
//
// Replace the TPU's Pallas kernels in bzip3_tpu/ops/device/lzp_pallas.py:
//   K5 lzp_encode_kernel <- _make_encode_kernel (:135), launched by
//      _encode_call (:425), public lzp_encode_pallas_batch (:506);
//   K6 lzp_decode_kernel <- _make_decode_kernel (:285), launched by
//      _decode_call (:469), public lzp_decode_pallas_batch (:518).
// Semantics: the reference LZP (src/libbz3.c:84-257) as the JAX
// package's oracle ops/ref/lzp.py states it, with the encoder's three
// quirks (the `heur` rejection window, word-granular extension plus
// 0..3 bytes, the out_cap break inside the base-254 length loop).  The
// plain version is ops/device/lzp.py, which the chip smoke test holds
// these kernels against byte for byte, and the port's host C++
// (csrc/host_stages.cpp) runs the same state machine on the host.
//
// What bounds them: a row is one serial state machine whose next step
// depends on a table entry (the hash of the last four bytes picks the
// slot, the slot's position picks the move), and the table of 2^18
// int32 (1 MiB a row) lives in device memory, L2-resident.  Done a byte
// at a time that is one L2 round trip, or two for the encoder's match
// test, a byte.  Bytes moved (each input byte read once, each output
// byte written once) would take well under a millisecond.  The design
// below turns that into a round trip or two a window of 32 bytes; what
// is left is the window's own chain of dependent shuffles, votes and
// branches, which one warp on its SM has nothing to hide behind
// (PERF.md gives the measured split).
//
// Design: one warp per row (rows CTAs of 32 threads).  The warp takes
// the row in speculative windows of 32 positions, each first assumed to
// be a literal: every lane gathers its own table entry at once, so a
// window pays one round trip (K6: only if it holds a 0xF2 byte; K5: one
// more for the match test of the lanes with a live prediction) for up
// to 32 bytes.  A lane sees what the serial loop would see: the
// position of the highest lower lane of the window with the same hash
// (window_peers: a 128 KB table of slots in shared memory, and
// __match_any_sync when two lanes meet in one), else the gathered entry.  The first lane whose
// step is not a plain literal (K5: passes the match test; K6: a 0xF2
// with a live prediction) is the window's event; the lanes before it
// commit as literals, the table stores cover the lanes up to and
// including it (the highest lane of each hash stores, so no atomics),
// and the whole warp resolves the event: K5 extends the match 32 words
// a step, K6 reads the base-254 length 32 bytes a step and copies 128
// bytes a step.  The next window starts after the event.  Positions
// only grow, so the stores and the output need no ordering beyond a
// __syncwarp() before the table or the output is read back (K5: between
// windows).
//
// Counters: with a non-null `stats`, each row writes kStats int32,
// K5 [windows, events, extension steps, matches, us], K6 [windows,
// events, windows that read the table, copy steps, us], where us is the
// row's own time in microseconds (the card's global timer).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLzpBits = 18;
constexpr uint32_t kLzpMask = (1u << kLzpBits) - 1u;
constexpr int32_t kMinMatch = 40;
constexpr uint32_t kToken = 0xF2u;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kStats = 5;
constexpr int32_t kPrefetch = 2048;  // bytes of input fetched ahead into L2
constexpr uint32_t kSlots = 1u << 17;  // window_peers' table: bytes of shared memory

__device__ __forceinline__ uint32_t lzp_hash(uint32_t ctx) {
    return ((ctx >> 15) ^ ctx ^ (ctx >> 3)) & kLzpMask;
}

// Big-endian word of the 4 input bytes at p (the context before p + 4).
__device__ __forceinline__ uint32_t be32_in(const uint8_t *__restrict__ p) {
    return ((uint32_t)__ldg(p) << 24) | ((uint32_t)__ldg(p + 1) << 16) |
           ((uint32_t)__ldg(p + 2) << 8) | (uint32_t)__ldg(p + 3);
}

__device__ __forceinline__ int32_t clamp_len(int64_t v, int64_t hi) {
    return (int32_t)(v < 0 ? 0 : (v > hi ? hi : v));
}

// Nanoseconds of the card's global timer (0 off the card).
__device__ __forceinline__ int64_t now_ns() {
    int64_t t = 0;
#ifdef __CUDA_ARCH__
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
#endif
    return t;
}

__device__ __forceinline__ void prefetch_l2(const void *p) {
#ifdef __CUDA_ARCH__
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// The lanes of the window whose hash equals this lane's (its own bit
// included; lanes past the window, !valid, get their own bit).  A
// window's hashes are nearly always distinct, and __match_any_sync,
// which finds equal ones, takes hundreds of cycles when all 32 differ
// (phase_latency of chip_smoke.py times it); so each valid lane first
// writes its number into the byte of `slots` that its hash picks, and
// only when a lane reads back another lane's number (two hashes, equal
// or not, on one slot) does the warp run __match_any_sync.  With 2^17
// slots, 32 random hashes share one in 0.4% of windows (1024 slots: 39%).
__device__ __forceinline__ uint32_t window_peers(uint8_t *slots, bool valid, uint32_t h,
                                                 uint32_t lane) {
    uint8_t *slot = slots + (h & (kSlots - 1));
    if (valid) *slot = (uint8_t)lane;
    __syncwarp();
    const bool clash = valid && *slot != lane;
    if (!__ballot_sync(kFull, clash)) return 1u << lane;
    return __match_any_sync(kFull, valid ? h : (0x80000000u | lane));
}

// The table entry this lane's position reads in the serial loop, when
// the window's lanes below it have stored theirs: the position of the
// highest lower lane with the same hash, else the gathered entry g.
__device__ __forceinline__ int32_t forward(uint32_t peers, uint32_t lane, int32_t base,
                                           int32_t g) {
    const uint32_t below = peers & ((1u << lane) - 1u);
    return below ? base + (31 - (int32_t)__clz(below)) : g;
}

// Whether this lane stores its position: it is at most `last` and no
// lane above it up to `last` has the same hash (positions only grow, so
// the highest one is the serial loop's final store).
__device__ __forceinline__ bool stores(uint32_t peers, uint32_t lane, int32_t last) {
    const uint32_t upto = (2u << last) - 1u;  // lanes 0..last; 2u << 31 wraps to 0
    return (int32_t)lane <= last && !(peers & upto & ~((2u << lane) - 1u));
}

// K5: encode row blockIdx.x, in[row, :lens[row]] -> out[row, :out_lens[row]],
// out_lens[row] = -1 when the row is under 72 bytes or its output
// reaches out_cap = n - 8 (the warp may stop anywhere once it has:
// such a row's bytes are unspecified).  lut is the row's zeroed
// 2^18-entry table.
__global__ void __launch_bounds__(32)
lzp_encode_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                  const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
                  int64_t out_width, int32_t *__restrict__ luts,
                  int32_t *__restrict__ out_lens, int32_t *__restrict__ stats) {
    const int64_t row = blockIdx.x;
    const uint32_t lane = threadIdx.x & 31u;
    const int32_t n = clamp_len(lens[row], in_width);
    if (n < kMinMatch + 32) {
        if (lane == 0) {
            out_lens[row] = -1;
            if (stats)
                for (int k = 0; k < kStats; ++k) stats[row * kStats + k] = 0;
        }
        return;
    }
    const int64_t t0 = now_ns();
    const uint8_t *__restrict__ src = in + row * in_stride;
    uint8_t *__restrict__ dst = out + row * out_width;
    int32_t *__restrict__ lut = luts + (row << kLzpBits);
    const int32_t out_cap = n - 8;
    const int32_t scan_end = n - kMinMatch - 32;
    extern __shared__ __align__(16) unsigned char smem[];
    uint8_t *slots = smem;
    if (lane < 4) dst[lane] = __ldg(src + lane);
    int32_t i = 4, op = 4, heur = 0;
    int32_t windows = 0, events = 0, ext_steps = 0, matches = 0;

    while (i < n && op < out_cap) {
        ++windows;
        if (lane == 0 && i + kPrefetch < n) prefetch_l2(src + i + kPrefetch);
        // 1. gather: the lane's context, hash and table entry
        const int32_t p = i + (int32_t)lane;
        const bool valid = p < n;
        const uint32_t ctx = valid ? be32_in(src + p - 4) : 0u;
        const uint32_t b = valid ? (uint32_t)__ldg(src + p) : 0u;
        const uint32_t h = lzp_hash(ctx);
        const int32_t g = valid ? lut[h] : 0;
        // 2. forwarding from the lower lanes of the window
        const uint32_t peers = window_peers(slots, valid, h, lane);
        const int32_t val = forward(peers, lane, i, g);
        // 3. the match test (:97-99 of the single-thread form) before scan_end
        bool cand = false;
        if (p < scan_end && val > 0)
            cand = be32_in(src + p + kMinMatch - 4) == be32_in(src + val + kMinMatch - 4) &&
                   be32_in(src + p) == be32_in(src + val) &&
                   !(heur > p && be32_in(src + heur) != be32_in(src + val + heur - p));
        const uint32_t ev = __ballot_sync(kFull, cand);
        const int32_t nvalid = n - i < 32 ? n - i : 32;
        const int32_t e = ev ? __ffs(ev) - 1 : nvalid;
        // 4. the table stores of lanes 0..e, the literals of lanes below e
        if (stores(peers, lane, ev ? e : nvalid - 1)) lut[h] = p;
        const bool lit = (int32_t)lane < e;
        const uint32_t esc = __ballot_sync(kFull, lit && b == kToken && val > 0);
        if (lit) {
            const int64_t o = (int64_t)op + lane + __popc(esc & ((1u << lane) - 1u));
            if (o < out_width) dst[o] = (uint8_t)b;
            if ((esc >> lane) & 1u && o + 1 < out_width) dst[o + 1] = 255;
        }
        op += e + __popc(esc);
        i += e;
        // 5. the event, with the whole warp
        if (ev) {
            ++events;
            const int32_t ve = __shfl_sync(kFull, val, e);
            const uint32_t be = __shfl_sync(kFull, b, e);
            int32_t ln = 4;
            for (;;) {  // word-granular extension, 32 words a step
                ++ext_steps;
                const int32_t q = ln + 4 * (int32_t)lane;
                const bool same = i + q < scan_end && be32_in(src + i + q) == be32_in(src + ve + q);
                const uint32_t miss = __ballot_sync(kFull, !same);
                if (miss) {
                    ln += 4 * (__ffs(miss) - 1);
                    break;
                }
                ln += 128;
            }
            if (ln < kMinMatch) {  // rejected: a literal, with a live prediction
                if (heur < i + ln) heur = i + ln;
                if (lane == 0 && op < out_width) dst[op] = (uint8_t)be;
                if (lane == 0 && be == kToken && op + 1 < out_width) dst[op + 1] = 255;
                op += 1 + (be == kToken);
                i += 1;
            } else {
                ++matches;
                // 0..3 bytes more (the leading equal ones of the next three)
                const uint32_t eq0 = __ldg(src + i + ln) == __ldg(src + ve + ln);
                const uint32_t eq1 = __ldg(src + i + ln + 1) == __ldg(src + ve + ln + 1);
                const uint32_t eq2 = __ldg(src + i + ln + 2) == __ldg(src + ve + ln + 2);
                ln += eq0 * (1 + eq1 * (1 + eq2));
                i += ln;
                // the token, then base-254 length bytes; a row that reaches
                // out_cap inside them reports -1, whatever follows
                const int32_t rem = ln - kMinMatch;
                const int32_t full = rem / 254;
                if (lane == 0 && op < out_width) dst[op] = (uint8_t)kToken;
                for (int64_t o = (int64_t)op + 1 + lane; o < (int64_t)op + 1 + full && o < out_width;
                     o += 32)
                    dst[o] = 254;
                if (lane == 0 && (int64_t)op + 1 + full < out_width)
                    dst[op + 1 + full] = (uint8_t)(rem - 254 * full);
                op += full + 2;
            }
        }
        __syncwarp();
    }
    if (lane == 0) {
        out_lens[row] = op >= out_cap ? -1 : op;
        if (stats) {
            int32_t *s = stats + row * kStats;
            s[0] = windows, s[1] = events, s[2] = ext_steps, s[3] = matches;
            s[4] = (int32_t)((now_ns() - t0) / 1000);
        }
    }
}

// K6: decode row blockIdx.x, in[row, :in_lens[row]] -> out[row, :out_lens[row]]
// with at most max_out (>= 4, <= out_width) bytes; out_lens[row] = -1 on
// a stream under 4 bytes (nothing is read) or a truncated token.
__global__ void __launch_bounds__(32)
lzp_decode_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                  const int32_t *__restrict__ in_lens, uint8_t *out, int64_t out_width,
                  int32_t max_out, int32_t *__restrict__ luts, int32_t *__restrict__ out_lens,
                  int32_t *__restrict__ stats) {
    const int64_t row = blockIdx.x;
    const uint32_t lane = threadIdx.x & 31u;
    const int32_t n = clamp_len(in_lens[row], in_width);
    if (n < 4) {
        if (lane == 0) {
            out_lens[row] = -1;
            if (stats)
                for (int k = 0; k < kStats; ++k) stats[row * kStats + k] = 0;
        }
        return;
    }
    const int64_t t0 = now_ns();
    const uint8_t *__restrict__ src = in + row * in_stride;
    uint8_t *dst = out + row * out_width;  // read back: no restrict, no __ldg
    int32_t *__restrict__ lut = luts + (row << kLzpBits);
    extern __shared__ __align__(16) unsigned char smem[];
    uint8_t *slots = smem;
    if (lane < 4) dst[lane] = __ldg(src + lane);
    uint32_t last4 = be32_in(src);  // the four output bytes before op
    int32_t ip = 4, op = 4;
    bool truncated = false;
    int32_t windows = 0, events = 0, gathers = 0, copy_steps = 0;

    while (ip < n && op < max_out) {
        ++windows;
        if (lane == 0 && ip + kPrefetch < n) prefetch_l2(src + ip + kPrefetch);
        int32_t nv = n - ip < max_out - op ? n - ip : max_out - op;
        nv = nv < 32 ? nv : 32;
        const bool valid = (int32_t)lane < nv;
        const uint32_t c = valid ? (uint32_t)__ldg(src + ip + lane) : 0u;
        // the lane's context: the output bytes op+lane-4 .. op+lane-1, from
        // the lanes below it or, before the window, from last4
        uint32_t ctx = 0;
#pragma unroll
        for (int d = 4; d >= 1; --d) {
            const uint32_t up = __shfl_up_sync(kFull, c, d);
            ctx = (ctx << 8) | ((int32_t)lane >= d ? up : (last4 >> (8 * (d - (int32_t)lane - 1))) & 0xFFu);
        }
        const uint32_t h = lzp_hash(ctx);
        const bool tok = valid && c == kToken;
        const uint32_t peers = window_peers(slots, valid, h, lane);
        int32_t val = 0;
        if (__ballot_sync(kFull, tok)) {  // only a 0xF2 reads the table
            ++gathers;
            __syncwarp();  // after the earlier windows' table stores
            val = forward(peers, lane, op, tok ? lut[h] : 0);
        }
        const uint32_t ev = __ballot_sync(kFull, tok && val > 0);
        const int32_t e = ev ? __ffs(ev) - 1 : nv;
        if (stores(peers, lane, ev ? e : nv - 1)) lut[h] = op + (int32_t)lane;
        if ((int32_t)lane < e) dst[op + lane] = (uint8_t)c;
        const uint32_t after = (ctx << 8) | c;  // the four output bytes ending at this lane's
        if (e > 0) last4 = __shfl_sync(kFull, after, e - 1);
        ip += e;
        op += e;
        if (ev) {
            ++events;
            const int32_t ve = __shfl_sync(kFull, val, e);
            if (++ip == n) {
                truncated = true;
                break;
            }
            if (__ldg(src + ip) == 255) {  // escaped literal token
                ++ip;
                if (lane == 0) dst[op] = (uint8_t)kToken;
                ++op;
                last4 = (last4 << 8) | kToken;
            } else {
                // the length: 40 + a run of 254s (in 64 bits: it may pass
                // 2^31) + the byte that ends it, 32 bytes a step
                int64_t ln = kMinMatch;
                for (;;) {
                    const bool in_range = ip + (int32_t)lane < n;
                    const uint32_t lb = in_range ? (uint32_t)__ldg(src + ip + lane) : 0u;
                    const uint32_t stop = __ballot_sync(kFull, !in_range || lb != 254);
                    const int32_t f = stop ? __ffs(stop) - 1 : 32;
                    ln += 254LL * f;
                    ip += f;
                    if (!stop) continue;
                    if (ip >= n) {
                        truncated = true;
                        break;
                    }
                    ln += __shfl_sync(kFull, lb, f);
                    ++ip;
                    break;
                }
                if (truncated) break;
                // the copy: out[op + q] = out[ve + q mod d], d = op - ve, reads
                // only bytes written before it, 128 bytes a step
                const int32_t stop = (int64_t)op + ln < max_out ? (int32_t)(op + ln) : max_out;
                const int32_t d = op - ve;
                const int32_t inc = 32 % d;
                int32_t r = (int32_t)lane % d;
                __syncwarp();  // after the literals and copies before it
                // the four output bytes before stop, the next context, read
                // where the copy reads them, with its first step
                uint32_t l4 = 0;
                if (lane < 4) {
                    const int32_t x = stop - 4 + (int32_t)lane;
                    l4 = dst[x < op ? x : ve + (x - op) % d];
                }
                for (int32_t q0 = op + (int32_t)lane; q0 - (int32_t)lane < stop; q0 += 128) {
                    ++copy_steps;
                    uint8_t v[4];
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        v[k] = q0 + 32 * k < stop ? dst[ve + r] : 0;
                        r += inc;
                        r -= r >= d ? d : 0;
                    }
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        if (q0 + 32 * k < stop) dst[q0 + 32 * k] = v[k];
                }
                op = stop;
                last4 = (__shfl_sync(kFull, l4, 0) << 24) | (__shfl_sync(kFull, l4, 1) << 16) |
                        (__shfl_sync(kFull, l4, 2) << 8) | __shfl_sync(kFull, l4, 3);
            }
        }
    }
    if (lane == 0) {
        out_lens[row] = truncated ? -1 : op;
        if (stats) {
            int32_t *s = stats + row * kStats;
            s[0] = windows, s[1] = events, s[2] = gathers, s[3] = copy_steps;
            s[4] = (int32_t)((now_ns() - t0) / 1000);
        }
    }
}

}  // namespace

// Launchers with a plain C interface.  Each returns the cudaError_t of
// its launch (0 on success).  luts is a zeroed [rows, 2^18] int32
// scratch; stats is null or [rows, 5] int32.

extern "C" int bz3t_lzp_encode(const uint8_t *in, int64_t in_stride, int64_t in_width,
                               const int32_t *lens, uint8_t *out, int64_t out_width,
                               int32_t *luts, int32_t *out_lens, int32_t *stats, int32_t rows,
                               void *stream) {
    cudaError_t e = cudaFuncSetAttribute(lzp_encode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSlots);
    if (e != cudaSuccess) return (int)e;
    lzp_encode_kernel<<<rows, 32, kSlots, (cudaStream_t)stream>>>(in, in_stride, in_width, lens,
                                                                  out, out_width, luts, out_lens,
                                                                  stats);
    return (int)cudaGetLastError();
}

extern "C" int bz3t_lzp_decode(const uint8_t *in, int64_t in_stride, int64_t in_width,
                               const int32_t *in_lens, uint8_t *out, int64_t out_width,
                               int32_t max_out, int32_t *luts, int32_t *out_lens, int32_t *stats,
                               int32_t rows, void *stream) {
    cudaError_t e = cudaFuncSetAttribute(lzp_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSlots);
    if (e != cudaSuccess) return (int)e;
    lzp_decode_kernel<<<rows, 32, kSlots, (cudaStream_t)stream>>>(in, in_stride, in_width,
                                                                  in_lens, out, out_width, max_out,
                                                                  luts, out_lens, stats);
    return (int)cudaGetLastError();
}
