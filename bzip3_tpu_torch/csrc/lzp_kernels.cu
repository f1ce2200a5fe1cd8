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
// What bounds them: each row is one serial state machine, a dependent
// chain of one table load and store per byte (the hash of the last four
// bytes picks the slot, the slot's position picks the next move).
// Bytes moved (each input byte read once, each output byte written
// once) would take well under a millisecond; the chain takes one memory
// round trip per byte.  The only parallelism is across rows.
//
// Design: one single-thread CTA per row.  A row's 2^18-entry table
// (1 MiB of int32) does not fit the 227 KB of shared memory a CTA may
// use, so it lives in device memory, in a [rows, 2^18] scratch the
// wrapper zeroes; 8 rows take 8 MiB, which stays in the 50 MB L2.
// The TPU kernel's packed-word tiling is a Mosaic workaround and is not
// carried over: bytes are loaded and stored one at a time, input through
// the read-only cache.  Every store is guarded by the row's output
// width.  The decoder reads back bytes it has just written (the
// overlapping match copy and the context after it), so its output is
// read through a plain pointer, never the read-only path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLzpBits = 18;
constexpr uint32_t kLzpMask = (1u << kLzpBits) - 1u;
constexpr int32_t kMinMatch = 40;
constexpr uint32_t kToken = 0xF2u;

__device__ __forceinline__ uint32_t lzp_hash(uint32_t ctx) {
    return ((ctx >> 15) ^ ctx ^ (ctx >> 3)) & kLzpMask;
}

// Big-endian word of the 4 input bytes at p (the context before p + 4).
__device__ __forceinline__ uint32_t be32_in(const uint8_t *__restrict__ p) {
    return ((uint32_t)__ldg(p) << 24) | ((uint32_t)__ldg(p + 1) << 16) |
           ((uint32_t)__ldg(p + 2) << 8) | (uint32_t)__ldg(p + 3);
}

// The same over output bytes this thread has written.
__device__ __forceinline__ uint32_t be32_out(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) |
           (uint32_t)p[3];
}

__device__ __forceinline__ int32_t clamp_len(int64_t v, int64_t hi) {
    return (int32_t)(v < 0 ? 0 : (v > hi ? hi : v));
}

// K5: encode row blockIdx.x, in[row, :lens[row]] -> out[row, :out_lens[row]],
// out_lens[row] = -1 when the row is under 72 bytes or its output
// reaches out_cap = n - 8.  lut is the row's zeroed 2^18-entry table.
__global__ void __launch_bounds__(1)
lzp_encode_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                  const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
                  int64_t out_width, int32_t *__restrict__ luts,
                  int32_t *__restrict__ out_lens) {
    const int64_t row = blockIdx.x;
    const int32_t n = clamp_len(lens[row], in_width);
    if (n < kMinMatch + 32) {
        out_lens[row] = -1;
        return;
    }
    const uint8_t *__restrict__ src = in + row * in_stride;
    uint8_t *__restrict__ dst = out + row * out_width;
    int32_t *__restrict__ lut = luts + (row << kLzpBits);
    const int32_t out_cap = n - 8;
    const int32_t scan_end = n - kMinMatch - 32;
    int32_t op = 0;
    auto emit = [&](uint32_t b) {
        if (op < out_width) dst[op] = (uint8_t)b;
        ++op;
    };

    for (int k = 0; k < 4; ++k) emit(__ldg(src + k));
    int32_t i = 4, heur = 0;
    uint32_t ctx = be32_in(src);

    while (i < scan_end && op < out_cap) {
        const uint32_t h = lzp_hash(ctx);
        const int32_t val = lut[h];
        lut[h] = i;
        if (val > 0 && be32_in(src + i + kMinMatch - 4) == be32_in(src + val + kMinMatch - 4) &&
            be32_in(src + i) == be32_in(src + val) &&
            !(heur > i && be32_in(src + heur) != be32_in(src + val + heur - i))) {
            int32_t ln = 4;
            while (i + ln < scan_end && be32_in(src + i + ln) == be32_in(src + val + ln)) ln += 4;
            if (ln < kMinMatch) {
                if (heur < i + ln) heur = i + ln;
            } else {
                for (int k = 0; k < 3; ++k)
                    if (__ldg(src + i + ln) == __ldg(src + val + ln)) ++ln;
                i += ln;
                ctx = be32_in(src + i - 4);
                emit(kToken);
                int32_t rem = ln - kMinMatch;
                while (rem >= 254) {
                    rem -= 254;
                    emit(254);
                    if (op >= out_cap) break;
                }
                emit((uint32_t)rem);
                continue;
            }
        }
        const uint32_t b = __ldg(src + i);
        ++i;
        emit(b);
        ctx = (ctx << 8) | b;
        if (b == kToken && val > 0) emit(255);
    }

    ctx = be32_in(src + i - 4);
    while (i < n && op < out_cap) {
        const uint32_t h = lzp_hash(ctx);
        const int32_t val = lut[h];
        lut[h] = i;
        const uint32_t b = __ldg(src + i);
        ++i;
        emit(b);
        ctx = (ctx << 8) | b;
        if (b == kToken && val > 0) emit(255);
    }
    out_lens[row] = op >= out_cap ? -1 : op;
}

// K6: decode row blockIdx.x, in[row, :in_lens[row]] -> out[row, :out_lens[row]]
// with at most max_out (>= 4, <= out_width) bytes; out_lens[row] = -1 on
// a stream under 4 bytes (nothing is read) or a truncated token.
__global__ void __launch_bounds__(1)
lzp_decode_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                  const int32_t *__restrict__ in_lens, uint8_t *out, int64_t out_width,
                  int32_t max_out, int32_t *__restrict__ luts, int32_t *__restrict__ out_lens) {
    const int64_t row = blockIdx.x;
    const int32_t n = clamp_len(in_lens[row], in_width);
    if (n < 4) {
        out_lens[row] = -1;
        return;
    }
    const uint8_t *__restrict__ src = in + row * in_stride;
    uint8_t *dst = out + row * out_width;  // read back: no restrict, no __ldg
    int32_t *__restrict__ lut = luts + (row << kLzpBits);
    for (int k = 0; k < 4; ++k) dst[k] = __ldg(src + k);
    int32_t ip = 4, op = 4;
    uint32_t ctx = be32_in(src);

    while (ip < n && op < max_out) {
        const uint32_t h = lzp_hash(ctx);
        const int32_t val = lut[h];
        lut[h] = op;
        const uint32_t b0 = __ldg(src + ip);
        if (b0 != kToken || val <= 0) {
            dst[op++] = (uint8_t)b0;
            ++ip;
            ctx = (ctx << 8) | b0;
            continue;
        }
        if (++ip == n) {
            out_lens[row] = -1;
            return;
        }
        if (__ldg(src + ip) == 255) {  // escaped literal token
            ++ip;
            dst[op++] = (uint8_t)kToken;
            ctx = (ctx << 8) | kToken;
            continue;
        }
        int64_t ln = kMinMatch;  // a run of 254s may pass 2^31
        for (;;) {
            if (ip == n) {
                out_lens[row] = -1;
                return;
            }
            const uint32_t c = __ldg(src + ip++);
            ln += c;
            if (c != 254) break;
        }
        const int32_t stop = op + ln < max_out ? (int32_t)(op + ln) : max_out;
        for (int32_t from = val; op < stop;) dst[op++] = dst[from++];  // may overlap
        ctx = be32_out(dst + op - 4);
    }
    out_lens[row] = op;
}

}  // namespace

// Launchers with a plain C interface.  Each returns the cudaError_t of
// its launch (0 on success).  luts is a zeroed [rows, 2^18] int32 scratch.

extern "C" int bz3t_lzp_encode(const uint8_t *in, int64_t in_stride, int64_t in_width,
                               const int32_t *lens, uint8_t *out, int64_t out_width,
                               int32_t *luts, int32_t *out_lens, int32_t rows, void *stream) {
    lzp_encode_kernel<<<rows, 1, 0, (cudaStream_t)stream>>>(in, in_stride, in_width, lens, out,
                                                             out_width, luts, out_lens);
    return (int)cudaGetLastError();
}

extern "C" int bz3t_lzp_decode(const uint8_t *in, int64_t in_stride, int64_t in_width,
                               const int32_t *in_lens, uint8_t *out, int64_t out_width,
                               int32_t max_out, int32_t *luts, int32_t *out_lens, int32_t rows,
                               void *stream) {
    lzp_decode_kernel<<<rows, 1, 0, (cudaStream_t)stream>>>(in, in_stride, in_width, in_lens,
                                                             out, out_width, max_out, luts,
                                                             out_lens);
    return (int)cudaGetLastError();
}
