// CM range coder kernels for Hopper (sm_90a): K1 encode, K2 decode and
// their resumable forms K3a-K3c.
//
// Replace the TPU's Pallas kernels in bzip3_tpu/ops/device/cm_pallas.py:
//   K1  cm_encode_kernel        <- _make_encode_kernel (:1379), public
//       cm_encode_pallas_batch (:2012);
//   K2  cm_decode_kernel        <- _make_decode_kernel (:450), public
//       cm_decode_pallas_batch (:1254);
//   K3a cm_encode_resume_kernel <- _make_encode_kernel(resume=True) in
//       _encode_call_resume (:1883), launch loop _encode_resumable (:1971);
//   K3b cm_decode_resume_kernel <- _make_decode_kernel(resume=True) in
//       _decode_call_resume (:1029), launch loop _decode_resumable (:1215);
//   K3c cm_decode_resume_kernel with out_rel <- _decode_call_resume_chunk
//       (:1100), public cm_decode_pallas_stream (:1163).
// K3a-K3c code the steps (bytes) [start, stop) of each row in one launch
// and carry the row's model and registers to the next launch in a
// global state buffer.  The wrappers cut a row into launches of 16 Mi
// steps (~19 s on an H100), so that no launch runs for minutes.
// Semantics: the reference coder, src/libbz3.c:331-494; plain PyTorch
// version in ops/device/cm.py, which the chip smoke test holds these
// kernels against byte for byte.
//
// What bounds them: each row is a bit-serial recurrence, 8 dependent
// bit steps per byte (predict from three tables, range split, renorm,
// counter update), so a row takes ~8*N times the latency of one step.
// Neither bytes moved nor operations done come near the card's rates.
// The only parallelism is across rows: one CTA codes one row, so a
// wave of 8 rows keeps 8 of the 132 SMs busy.  Filling the card is
// later work.  A resumable launch adds one copy of the row's 149 KB of
// tables in and one out, by the whole CTA in 16-byte words.
//
// Design: one CTA per row.  The row's model (C1 128 KiB, C2 17 KiB,
// C0 0.5 KiB) lives in dynamic shared memory; the whole CTA
// initialises (or loads) it, then one thread runs the coder.  Input is
// read straight from global memory through a 16-byte window that loads
// the next window ahead of use, so a load's latency is hidden behind
// the bit steps of the bytes before it; output bytes are stored
// straight to global memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kC0 = 256;
constexpr int kC1 = 256 * 256;
constexpr int kC2 = 512 * 17;
constexpr int kSmemBytes = (kC0 + kC1 + kC2) * 2;  // 148,992 bytes
// A row's state between resumable launches: its tables as they lie in
// shared memory, then 16 int32 registers.  A multiple of 16 bytes.
constexpr int kStateBytes = kSmemBytes + 64;
constexpr int kThreads = 256;
constexpr uint32_t kTop = 1u << 24;

struct Model {
    uint16_t *c0, *c1, *c2;
};

// v clamped to [0, hi].
__device__ __forceinline__ int32_t clamp_len(int64_t v, int64_t hi) {
    return (int32_t)(v < 0 ? 0 : (v > hi ? hi : v));
}

__device__ __forceinline__ Model model_at(unsigned char *smem) {
    uint16_t *c0 = reinterpret_cast<uint16_t *>(smem);
    return Model{c0, c0 + kC0, c0 + kC0 + kC1};
}

// Fresh tables (src/libbz3.c:350-358), written by the whole CTA.
__device__ Model init_model(unsigned char *smem) {
    uint32_t *w = reinterpret_cast<uint32_t *>(smem);
    for (int i = threadIdx.x; i < (kC0 + kC1) / 2; i += blockDim.x) w[i] = 0x80008000u;
    const Model m = model_at(smem);
    for (int i = threadIdx.x; i < kC2; i += blockDim.x) {
        const int k = i % 17;
        m.c2[i] = (uint16_t)((k << 12) - (k == 16));
    }
    __syncthreads();
    return m;
}

// Tables of a resumable row: fresh in its first launch, else loaded
// from the row's state.  The whole CTA, 16-byte words.
__device__ Model resume_model(unsigned char *smem, const uint8_t *state, bool first) {
    if (first) return init_model(smem);
    const uint4 *src = reinterpret_cast<const uint4 *>(state);
    uint4 *dst = reinterpret_cast<uint4 *>(smem);
    for (int i = threadIdx.x; i < kSmemBytes / 16; i += blockDim.x) dst[i] = src[i];
    __syncthreads();
    return model_at(smem);
}

// The row's tables back to its state, by the whole CTA once the coding
// thread is done.
__device__ void spill_model(const unsigned char *smem, uint8_t *state) {
    __syncthreads();
    const uint4 *src = reinterpret_cast<const uint4 *>(smem);
    uint4 *dst = reinterpret_cast<uint4 *>(state);
    for (int i = threadIdx.x; i < kSmemBytes / 16; i += blockDim.x) dst[i] = src[i];
}

// Sequential byte reader over one row of `width` bytes (a multiple of
// 16, 16-byte aligned).  Holds the current 16-byte window and the next
// one, already requested; bytes past the row read as 0.
struct Reader {
    const uint4 *src;
    int64_t nchunks, next;
    uint4 cur, nxt;
    int k;

    __device__ void init(const uint8_t *row, int64_t width) {
        src = reinterpret_cast<const uint4 *>(row);
        nchunks = width / 16;
        cur = nchunks > 0 ? __ldg(src) : make_uint4(0, 0, 0, 0);
        nxt = nchunks > 1 ? __ldg(src + 1) : make_uint4(0, 0, 0, 0);
        next = 2;
        k = 0;
    }

    __device__ uint32_t byte() {
        const uint32_t w = k < 8 ? (k < 4 ? cur.x : cur.y) : (k < 12 ? cur.z : cur.w);
        const uint32_t b = (w >> ((k & 3) * 8)) & 0xFFu;
        if (++k == 16) {
            cur = nxt;
            nxt = next < nchunks ? __ldg(src + next) : make_uint4(0, 0, 0, 0);
            ++next;
            k = 0;
        }
        return b;
    }
};

// One bit's prediction (src/libbz3.c:376-387).
struct Pred {
    int p0, p1, x1, x2, sse;
    uint32_t scale;  // ssep * 3 + p, below 2^18
};

__device__ __forceinline__ Pred predict(const Model &m, const uint16_t *r1,
                                        const uint16_t *r2, uint32_t ctx, uint32_t f) {
    Pred q;
    q.p0 = m.c0[ctx];
    q.p1 = r1[ctx];
    const int p2 = r2[ctx];
    const int p = ((q.p0 + q.p1) * 7 + p2 + p2) >> 4;
    q.sse = (int)(2 * ctx + f) * 17 + (p >> 12);
    q.x1 = m.c2[q.sse];
    q.x2 = m.c2[q.sse + 1];
    // signed: x2 - x1 may be negative; >> is an arithmetic (floor) shift
    const int ssep = q.x1 + (((q.x2 - q.x1) * (p & 4095)) >> 12);
    q.scale = (uint32_t)(ssep * 3 + p);
    return q;
}

__device__ __forceinline__ uint32_t split(uint32_t low, uint32_t high, uint32_t scale) {
    return (uint32_t)(((uint64_t)(high - low) * scale) >> 18);
}

// Counter updates with rates 2/4/6 (src/libbz3.c:347-348).
__device__ __forceinline__ void update(const Model &m, uint16_t *r1, uint32_t ctx,
                                       const Pred &q, uint32_t bit) {
    if (bit) {
        m.c0[ctx] = (uint16_t)(q.p0 + ((q.p0 ^ 65535) >> 2));
        r1[ctx] = (uint16_t)(q.p1 + ((q.p1 ^ 65535) >> 4));
        m.c2[q.sse] = (uint16_t)(q.x1 + ((q.x1 ^ 65535) >> 6));
        m.c2[q.sse + 1] = (uint16_t)(q.x2 + ((q.x2 ^ 65535) >> 6));
    } else {
        m.c0[ctx] = (uint16_t)(q.p0 - (q.p0 >> 2));
        r1[ctx] = (uint16_t)(q.p1 - (q.p1 >> 4));
        m.c2[q.sse] = (uint16_t)(q.x1 - (q.x1 >> 6));
        m.c2[q.sse + 1] = (uint16_t)(q.x2 - (q.x2 >> 6));
    }
}

// Range coder registers of one row.
struct EncRegs {
    uint32_t low, high, c1, c2;
    int32_t optr, run;
};
struct DecRegs {
    uint32_t low, high, code, c1, c2;
    int32_t ip, run;
};
__device__ __forceinline__ EncRegs enc_fresh() { return EncRegs{0, 0xFFFFFFFFu, 0, 0, 0, 0}; }

// Encode the next `count` bytes of rd, storing payload byte optr at
// dst[optr] while optr < out_width and counting it either way.
__device__ __forceinline__ void encode_bytes(const Model &m, Reader &rd, uint8_t *dst,
                                             int32_t out_width, EncRegs &r, int32_t count) {
    uint32_t low = r.low, high = r.high, c1 = r.c1, c2 = r.c2;
    int32_t optr = r.optr, run = r.run;
    for (int32_t i = 0; i < count; ++i) {
        const uint32_t c = rd.byte();
        run = c1 == c2 ? run + 1 : 0;
        const uint32_t f = run > 2;
        uint16_t *r1 = m.c1 + (c1 << 8);
        const uint16_t *r2 = m.c1 + (c2 << 8);
        uint32_t ctx = 1;
#pragma unroll
        for (int b = 7; b >= 0; --b) {
            const uint32_t bit = (c >> b) & 1u;
            const Pred q = predict(m, r1, r2, ctx, f);
            const uint32_t step = split(low, high, q.scale);
            if (bit)
                high = low + step;
            else
                low = low + step + 1;
            while ((low ^ high) < kTop) {
                if (optr < out_width) dst[optr] = (uint8_t)(low >> 24);
                ++optr;
                low <<= 8;
                high = (high << 8) | 0xFFu;
            }
            update(m, r1, ctx, q, bit);
            ctx = 2 * ctx + bit;
        }
        c2 = c1;
        c1 = ctx & 255u;
    }
    r = EncRegs{low, high, c1, c2, optr, run};
}

// The encoder's flush (src/libbz3.c:426-433): the payload's last 4 bytes.
__device__ __forceinline__ void encode_flush(uint8_t *dst, int32_t out_width, EncRegs &r) {
    for (int k = 0; k < 4; ++k) {
        if (r.optr < out_width) dst[r.optr] = (uint8_t)(r.low >> 24);
        ++r.optr;
        r.low <<= 8;
    }
}

// The next code byte: input past n_in reads as 0xFFFFFFFF, so an
// exhausted stream shifts in (code << 8) - 1 (src/libbz3.c:346,437-440).
__device__ __forceinline__ uint32_t code_byte(Reader &rd, int32_t &ip, int32_t n_in) {
    const uint32_t b = rd.byte();
    const uint32_t v = ip < n_in ? b : 0xFFFFFFFFu;
    ip += ip < n_in;
    return v;
}

// The decoder's first four code bytes.
__device__ __forceinline__ DecRegs decode_start(Reader &rd, int32_t n_in) {
    DecRegs r{0, 0xFFFFFFFFu, 0, 0, 0, 0, 0};
    for (int k = 0; k < 4; ++k) r.code = (r.code << 8) + code_byte(rd, r.ip, n_in);
    return r;
}

// Decode the next `count` bytes into dst[0, count).
__device__ __forceinline__ void decode_bytes(const Model &m, Reader &rd, int32_t n_in,
                                             uint8_t *dst, DecRegs &r, int32_t count) {
    uint32_t low = r.low, high = r.high, code = r.code, c1 = r.c1, c2 = r.c2;
    int32_t ip = r.ip, run = r.run;
    for (int32_t i = 0; i < count; ++i) {
        run = c1 == c2 ? run + 1 : 0;
        const uint32_t f = run > 2;
        uint16_t *r1 = m.c1 + (c1 << 8);
        const uint16_t *r2 = m.c1 + (c2 << 8);
        uint32_t ctx = 1;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            const Pred q = predict(m, r1, r2, ctx, f);
            const uint32_t mid = low + split(low, high, q.scale);
            const uint32_t bit = code <= mid;
            if (bit)
                high = mid;
            else
                low = mid + 1;
            while ((low ^ high) < kTop) {
                low <<= 8;
                high = (high << 8) | 0xFFu;
                code = (code << 8) + code_byte(rd, ip, n_in);
            }
            update(m, r1, ctx, q, bit);
            ctx = 2 * ctx + bit;
        }
        c2 = c1;
        c1 = ctx & 255u;
        dst[i] = (uint8_t)c1;
    }
    r = DecRegs{low, high, code, c1, c2, ip, run};
}

// K1: encode row blockIdx.x, in[row, :lens[row]] -> out[row, :out_lens[row]].
// Rows are in_stride bytes apart (a multiple of 16), of which the first
// in_width are the row; lens are clamped to [0, in_width].
// A payload longer than out_width keeps counting (the true length is
// reported) while its writes past out_width are dropped.
__global__ void __launch_bounds__(kThreads)
cm_encode_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                 const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
                 int64_t out_stride, int32_t out_width, int32_t *__restrict__ out_lens) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Model m = init_model(smem);
    if (threadIdx.x != 0) return;
    const int64_t row = blockIdx.x;
    const int32_t n = clamp_len(lens[row], in_width);
    Reader rd;
    rd.init(in + row * in_stride, in_stride);
    uint8_t *dst = out + row * out_stride;
    EncRegs r = enc_fresh();
    encode_bytes(m, rd, dst, out_width, r, n);
    encode_flush(dst, out_width, r);
    out_lens[row] = r.optr;
}

// K2: decode out_lens[row] bytes of row blockIdx.x.  Input past
// in_lens[row] (clamped to in_width) reads as 0xFFFFFFFF: an exhausted
// stream shifts in (code << 8) - 1 (src/libbz3.c:346,437-440).
__global__ void __launch_bounds__(kThreads)
cm_decode_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                 const int32_t *__restrict__ in_lens, const int32_t *__restrict__ out_lens,
                 uint8_t *__restrict__ out, int64_t out_stride) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Model m = init_model(smem);
    if (threadIdx.x != 0) return;
    const int64_t row = blockIdx.x;
    const int32_t n_in = clamp_len(in_lens[row], in_width);
    const int32_t n = clamp_len(out_lens[row], out_stride);
    Reader rd;
    rd.init(in + row * in_stride, in_stride);
    DecRegs r = decode_start(rd, n_in);
    decode_bytes(m, rd, n_in, out + row * out_stride, r, n);
}

// K3a: K1 over the steps [start, stop) of row blockIdx.x (start a
// multiple of 16).  The row's tables and registers come from state[row]
// (fresh when start is 0) and go back there when the row runs on past
// stop.  Payload bytes go to their absolute offsets, dropped past
// out_width; the row that ends in this launch is flushed and its true
// length written.  A row that ended in an earlier launch is left alone.
__global__ void __launch_bounds__(kThreads)
cm_encode_resume_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                        const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
                        int64_t out_stride, int32_t out_width, int32_t *__restrict__ out_lens,
                        uint8_t *__restrict__ state, int32_t start, int32_t stop) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t row = blockIdx.x;
    const int32_t n = clamp_len(lens[row], in_width);
    if (start > 0 && n <= start) return;  // the whole CTA: flushed already
    uint8_t *st = state + row * kStateBytes;
    int32_t *regs = reinterpret_cast<int32_t *>(st + kSmemBytes);
    const Model m = resume_model(smem, st, start == 0);
    if (threadIdx.x == 0) {
        EncRegs r = enc_fresh();
        if (start > 0)
            r = EncRegs{(uint32_t)regs[0], (uint32_t)regs[1], (uint32_t)regs[2],
                        (uint32_t)regs[3], regs[4], regs[5]};
        Reader rd;
        rd.init(in + row * in_stride + start, in_stride - start);
        uint8_t *dst = out + row * out_stride;
        encode_bytes(m, rd, dst, out_width, r, min(n, stop) - start);
        if (n <= stop) {
            encode_flush(dst, out_width, r);
            out_lens[row] = r.optr;
        } else {
            regs[0] = (int32_t)r.low, regs[1] = (int32_t)r.high, regs[2] = (int32_t)r.c1;
            regs[3] = (int32_t)r.c2, regs[4] = r.optr, regs[5] = r.run;
        }
    }
    if (n > stop) spill_model(smem, st);
}

// K3b (out_rel 0) and K3c (out_rel 1): K2 over the steps [start, stop)
// of row blockIdx.x, with state as in K3a.  K3b writes decoded byte i at
// out[row, i]; K3c at out[row, i - start] of a [rows, stop - start]
// buffer.  Rows decode out_lens[row] bytes, clamped to out_width.  The
// first four code bytes are read in the first launch; a later launch
// resumes the input at byte ip, from the 16-byte word that holds it.
__global__ void __launch_bounds__(kThreads)
cm_decode_resume_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                        const int32_t *__restrict__ in_lens, const int32_t *__restrict__ out_lens,
                        int32_t out_width, uint8_t *__restrict__ out, int64_t out_stride,
                        int32_t out_rel, uint8_t *__restrict__ state, int32_t start,
                        int32_t stop) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t row = blockIdx.x;
    const int32_t n = clamp_len(out_lens[row], out_width);
    if (start > 0 && n <= start) return;  // the whole CTA: done already
    uint8_t *st = state + row * kStateBytes;
    int32_t *regs = reinterpret_cast<int32_t *>(st + kSmemBytes);
    const Model m = resume_model(smem, st, start == 0);
    if (threadIdx.x == 0) {
        const int32_t n_in = clamp_len(in_lens[row], in_width);
        const uint8_t *src = in + row * in_stride;
        Reader rd;
        DecRegs r;
        if (start == 0) {
            rd.init(src, in_stride);
            r = decode_start(rd, n_in);
        } else {
            r = DecRegs{(uint32_t)regs[0], (uint32_t)regs[1], (uint32_t)regs[2],
                        (uint32_t)regs[3], (uint32_t)regs[4], regs[5], regs[6]};
            const int32_t word = r.ip & ~15;
            rd.init(src + word, in_stride - word);
            for (int k = 0; k < (r.ip & 15); ++k) rd.byte();
        }
        uint8_t *dst = out + row * out_stride + (out_rel ? 0 : start);
        decode_bytes(m, rd, n_in, dst, r, min(n, stop) - start);
        if (n > stop) {
            regs[0] = (int32_t)r.low, regs[1] = (int32_t)r.high, regs[2] = (int32_t)r.code;
            regs[3] = (int32_t)r.c1, regs[4] = (int32_t)r.c2, regs[5] = r.ip, regs[6] = r.run;
        }
    }
    if (n > stop) spill_model(smem, st);
}

}  // namespace

// Launchers with a plain C interface.  Each returns the cudaError_t of
// its launch (0 on success): a launch the runtime refuses never runs.

extern "C" int bz3t_cm_encode(const uint8_t *in, int64_t in_stride, int64_t in_width,
                              const int32_t *lens, uint8_t *out, int64_t out_stride,
                              int32_t out_width, int32_t *out_lens, int32_t rows,
                              void *stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    cm_encode_kernel<<<rows, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        in, in_stride, in_width, lens, out, out_stride, out_width, out_lens);
    return (int)cudaGetLastError();
}

extern "C" int bz3t_cm_decode(const uint8_t *in, int64_t in_stride, int64_t in_width,
                              const int32_t *in_lens, const int32_t *out_lens, uint8_t *out,
                              int64_t out_stride, int32_t rows, void *stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    cm_decode_kernel<<<rows, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        in, in_stride, in_width, in_lens, out_lens, out, out_stride);
    return (int)cudaGetLastError();
}

extern "C" int bz3t_cm_encode_resume(const uint8_t *in, int64_t in_stride, int64_t in_width,
                                     const int32_t *lens, uint8_t *out, int64_t out_stride,
                                     int32_t out_width, int32_t *out_lens, uint8_t *state,
                                     int32_t start, int32_t stop, int32_t rows, void *stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_encode_resume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    cm_encode_resume_kernel<<<rows, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        in, in_stride, in_width, lens, out, out_stride, out_width, out_lens, state, start, stop);
    return (int)cudaGetLastError();
}

extern "C" int bz3t_cm_decode_resume(const uint8_t *in, int64_t in_stride, int64_t in_width,
                                     const int32_t *in_lens, const int32_t *out_lens,
                                     int32_t out_width, uint8_t *out, int64_t out_stride,
                                     int32_t out_rel, uint8_t *state, int32_t start,
                                     int32_t stop, int32_t rows, void *stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_decode_resume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    cm_decode_resume_kernel<<<rows, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        in, in_stride, in_width, in_lens, out_lens, out_width, out, out_stride, out_rel, state,
        start, stop);
    return (int)cudaGetLastError();
}

// Bytes of one row's state for the resumable kernels.
extern "C" int64_t bz3t_cm_state_bytes() { return kStateBytes; }

extern "C" const char *bz3t_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
