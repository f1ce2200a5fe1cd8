// The parallel CM encoder's kernels for Hopper (sm_90a): P1, the window
// scans of the per-slot counter chains, and P2, the range coder over
// precomputed split factors.
//
// They stand where the JAX package runs XLA-level loops, not Pallas
// kernels, in bzip3_tpu/ops/device/cm_parallel.py:
//   P1  chain_windows_kernel <- the lax.scan passes of _chain_values_sorted
//       (:137-219): step_pair (bracket and relax), step_map (sampled
//       maps), step_emit (per-event values); speculative=False
//       (_chain_values_exact, :46-65) is the emit pass over one window;
//   P2  range_pass_kernel    <- cstep, the lax.scan over byte steps
//       (:343-377), and its compaction (:379-405).
// Both loops are sequential; as tensor calls from Python they would be
// ~0.5 M launches (P1) and ~80 M (P2) at a 2 MiB row.  Plain PyTorch
// versions: chain_windows_plain and range_pass_plain in
// ops/device/cm_parallel.py, which chip_smoke.py holds these against.
//
// P1: one thread a (row, window) in the pair and emit passes, one a
// (row, window, sample) in the map pass, steps through the window's seg
// events of a (slot, time)-sorted stream.  An event is one word: init
// value (bits 0-15), bit (16), advance (17), start (18).  The stream lies
// scan-major, [rows, seg, windows] (the tensor code transposes it once a
// chain, 8 bytes an event), so the threads of a warp read one contiguous
// run of words a step, and the samples of a window (a warp's lanes, 4,
// 16 or 64 of them) read the same word, one broadcast.  Window 0's entry
// is arbitrary and padding events reset, as every group start does.
// Bound: the events read, 4 bytes each a pass, against a dependent chain
// of seg counter steps a thread; the card holds enough threads (S windows
// of 2,048 events, S = 8N/2048 or 16N/2048 a row) that bytes bound it.
//
// P2: one warp a row, every lane on the same registers and writing the
// same bytes (one store a warp), as K1's coder warp.  The warp stages 128
// split factors (4 a lane, 16-byte loads) in shared memory and loads the
// next 128 while it codes them, so the loads stay off the coder's
// dependent chain: split (IMAD.HI), select, renorm count (FLO), shifts,
// the same steps as K1 (cm_coder.cuh).  Payload bytes go straight to the
// row's output at a running offset, capped at out_width with the true
// length reported, then the 4 flush bytes of low.  Bound: 8 bit steps a
// byte of the longest row at the coder's dependent chain.

#include <cstdint>
#include <cuda_runtime.h>

#include "cm_coder.cuh"  // split_hi, adapt, renorm_shift, renorm

namespace {

constexpr uint32_t kInitMask = 0xFFFFu, kBit = 1u << 16, kAdv = 1u << 17, kStart = 1u << 18;
enum { kPair = 0, kMap = 1, kEmit = 2 };  // cm_parallel.MODES
constexpr int kWinThreads = 256;
constexpr int kChunk = 128;  // split factors P2's warp stages at a time

// Event e on counter c: a start resets c to the event's init value, an
// advancing event steps it toward the event's bit.  Returns c before the
// step (the value the event reads).
__device__ __forceinline__ int32_t on_event(uint32_t e, int32_t &c, int rate) {
    c = (e & kStart) ? (int32_t)(e & kInitMask) : c;
    const int32_t pre = c;
    c = (e & kAdv) ? adapt(c, e & kBit, rate) : c;
    return pre;
}

// P1: one pass over every window of ev [rows, seg, nwin].  kPair: from
// entries in0, in1 [rows, nwin] the exits to out0, out1; kMap: from the
// entries min(in0 + s, 65535), s < 2^rate, the exits to out0 [rows, nwin,
// 2^rate]; kEmit: from entries in0 each event's value before it, to out0
// [rows, seg, nwin].
__global__ void __launch_bounds__(kWinThreads)
chain_windows_kernel(const uint32_t *__restrict__ ev, int64_t rows, int32_t seg, int32_t nwin,
                     int32_t rate, int32_t mode, const int32_t *__restrict__ in0,
                     const int32_t *__restrict__ in1, int32_t *__restrict__ out0,
                     int32_t *__restrict__ out1) {
    const int32_t lanes = mode == kMap ? 1 << rate : 1;
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows * nwin * lanes) return;
    const int64_t win = t / lanes;  // row * nwin + window
    const int64_t row = win / nwin;
    const int64_t first = row * seg * nwin + (win - row * nwin);  // event 0 of the window
    const uint32_t *src = ev + first;
    if (mode == kPair) {
        int32_t c0 = in0[win], c1 = in1[win];
#pragma unroll 8
        for (int32_t i = 0; i < seg; ++i) {
            const uint32_t e = __ldg(src + (int64_t)i * nwin);
            on_event(e, c0, rate);
            on_event(e, c1, rate);
        }
        out0[win] = c0;
        out1[win] = c1;
    } else if (mode == kMap) {
        int32_t c = min(in0[win] + (int32_t)(t - win * lanes), 65535);
#pragma unroll 8
        for (int32_t i = 0; i < seg; ++i) on_event(__ldg(src + (int64_t)i * nwin), c, rate);
        out0[t] = c;
    } else {
        int32_t c = in0[win];
        int32_t *dst = out0 + first;
#pragma unroll 8
        for (int32_t i = 0; i < seg; ++i)
            dst[(int64_t)i * nwin] = on_event(__ldg(src + (int64_t)i * nwin), c, rate);
    }
}

// P2: the range coder of row blockIdx.x over its first 8 * lens[row]
// words of words[row, 0:stride) (the split factor in bits 0-17, the bit
// in bit 31; lens clamped to [0, stride / 8]).  Payload byte optr goes
// to out[row, optr] while optr < out_width and is counted either way;
// then the flush (src/libbz3.c:426-433) and the length to out_lens[row].
__global__ void __launch_bounds__(32)
range_pass_kernel(const uint32_t *__restrict__ words, int64_t stride,
                  const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
                  int64_t out_stride, int32_t out_width, int32_t *__restrict__ out_lens) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t *buf = reinterpret_cast<uint32_t *>(smem);
    const int64_t row = blockIdx.x;
    const uint32_t lane = threadIdx.x;
    const int64_t len = lens[row];
    const int64_t nbits = 8 * (len < 0 ? 0 : (len > stride / 8 ? stride / 8 : len));
    const uint4 *src = reinterpret_cast<const uint4 *>(words + row * stride);
    uint8_t *dst = out + row * out_stride;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4 nxt = 4 * (int64_t)lane < nbits ? __ldg(src + lane) : zero;
    uint32_t low = 0, high = 0xFFFFFFFFu;
    int32_t optr = 0;
    for (int64_t base = 0; base < nbits; base += kChunk) {
        __syncwarp();  // every lane is done with the last chunk
        reinterpret_cast<uint4 *>(buf)[lane] = nxt;
        __syncwarp();
        const int64_t q = base + kChunk + 4 * (int64_t)lane;
        nxt = q < nbits ? __ldg(src + q / 4) : zero;  // in flight while this chunk codes
        // a byte step at a time, its 8 factors in two 16-byte loads, as
        // K1's coder reads its ring
        const int32_t steps = (int32_t)min((int64_t)kChunk, nbits - base) / 8;
        for (int32_t i = 0; i < steps; ++i) {
            const uint4 h0 = reinterpret_cast<const uint4 *>(buf)[2 * i];
            const uint4 h1 = reinterpret_cast<const uint4 *>(buf)[2 * i + 1];
            const uint32_t ws[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const uint32_t w = ws[b];
                const uint32_t step = split_hi(low, high, (w & 0x3FFFFu) << 14);
                if (w >> 31)
                    high = low + step;
                else
                    low = low + step + 1;
                const uint32_t sh = renorm_shift(low, high);
                const int32_t lim = min((int32_t)(sh >> 3), out_width - optr);
                uint8_t *p = dst + optr;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (j < lim) p[j] = (uint8_t)(low >> (24 - 8 * j));
                optr += sh >> 3;
                renorm(low, high, sh);
            }
        }
    }
    for (int j = 0; j < 4; ++j)
        if (optr + j < out_width) dst[optr + j] = (uint8_t)(low >> (24 - 8 * j));
    if (lane == 0) out_lens[row] = optr + 4;
}

}  // namespace

// Launchers with a plain C interface; each returns the cudaError_t of its
// launch (0 on success).

extern "C" int bz3t_chain_windows(const uint32_t *ev, int64_t rows, int32_t seg, int32_t nwin,
                                  int32_t rate, int32_t mode, const int32_t *in0,
                                  const int32_t *in1, int32_t *out0, int32_t *out1,
                                  void *stream) {
    const int64_t threads = rows * nwin * (mode == kMap ? 1 << rate : 1);
    if (threads == 0) return 0;
    const int64_t blocks = (threads + kWinThreads - 1) / kWinThreads;
    chain_windows_kernel<<<(unsigned)blocks, kWinThreads, 0, (cudaStream_t)stream>>>(
        ev, rows, seg, nwin, rate, mode, in0, in1, out0, out1);
    return (int)cudaGetLastError();
}

extern "C" int bz3t_range_pass(const uint32_t *words, int64_t stride, const int32_t *lens,
                               uint8_t *out, int64_t out_stride, int32_t out_width,
                               int32_t *out_lens, int32_t rows, void *stream) {
    range_pass_kernel<<<rows, 32, kChunk * 4, (cudaStream_t)stream>>>(
        words, stride, lens, out, out_stride, out_width, out_lens);
    return (int)cudaGetLastError();
}
