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
// steps, so that no launch runs for minutes.
// Semantics: the reference coder, src/libbz3.c:331-494; plain PyTorch
// version in ops/device/cm.py, which the chip smoke test holds these
// kernels against byte for byte.
//
// What bounds them: each row is a bit-serial recurrence, so a row takes
// ~8*N times the latency of one bit step on its critical path.  Neither
// bytes moved nor operations done come near the card's rates.  The only
// parallelism is across rows: one CTA codes one row, so a wave of 8 rows
// keeps 8 of the 132 SMs busy.  Filling the card is later work.
//
// Common to all: one CTA per row; the row's model (C1 128 KiB, C2
// 17 KiB, C0 0.5 KiB) lives in dynamic shared memory, initialised (or
// loaded) by the whole CTA; input is read from global memory ahead of
// use; output bytes are stored straight to global memory.
//
// K1 and K2 take the model off the coder's path.  Within one byte the
// run flag f is fixed and the 8 visited nodes have distinct C0 and C1
// slots and distinct SSE rows (2*ctx+f)*17 (sse+1 stays in its row, as
// p <= 65535), so every read of a byte may precede all of its updates
// (the TPU kernel's rule, cm_pallas.py:33-37).  The renorm count is
// closed-form, clz(low ^ high) / 8 bytes, with no loop and no branch.
// - K1: warp 0 models: lane b of 8 loads node b's counters and knots of
//   byte t at once (the encoder knows all 8 contexts), writes the 8
//   split factors (bit in bit 31) to a ring of 4 slots of 256 bytes in
//   shared memory and updates the 8 nodes.  Warp 1 codes from the ring
//   on registers only: split, select, renorm.  The model of byte t+1
//   needs only the data and byte t's stores, so it runs ahead of the
//   coder; named barriers hand over whole slots.  Bound: the coder's
//   register chain per bit.
// - K2: the next context depends on the decoded bit, so the model
//   cannot run ahead across bytes.  At each byte's start thread j of 256
//   predicts node j from the tables as they stand (each thread reads and
//   writes only its own node's counters and SSE row, so no barrier sits
//   between a byte's update and the next byte's predictions) into a
//   256-word tree in shared memory; warp 0 walks the 8 bits with both
//   children's factors loaded while a bit is coded, then each thread on
//   the byte's path updates its node.  Warp 0 predicts nodes 1-31
//   itself (and each of its lanes the root as well, so bit 0 waits for
//   no hand-off) and walks 4 bits before it waits for nodes 32-255.
//   Bound: the walk's 8 coder steps plus one node prediction per byte.
// Neither coder branches or diverges per bit: every lane of a coder warp
// runs the same registers and stores the same bytes, the counter updates
// select between both outcomes and their addresses, and K2 takes its
// code bytes from a 64-byte window of the payload that warp 0 stages in
// shared memory at each byte's start.  The split is one IMAD.HI
// (split_hi).  What is left on a bit's path: the split, the select of
// low/high, the renorm count (FLO) and the shifts; in K2 also the compare
// with code and the pick of the child's factor.
// K3a runs K1's body (encode_steps) and K3b/K3c K2's (decode_steps), as
// the JAX package builds them from one factory each; a resumable kernel
// adds only a prologue (fresh tables and registers when start is 0,
// else loaded from the row's state) and an epilogue (the flush when the
// row ends in this launch, else the registers stored and the tables
// spilled by the whole CTA).  K3a's warps 2-7 wait at the spill's
// __syncthreads() while warps 0-1 code, so no barrier follows a
// divergent return.

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
// K1's ring of split factors after the tables: kSlots slots of
// kSlotBytes bytes, 8 words a byte.  Named barriers 1..kSlots mark a
// slot full, kSlots+1..2*kSlots empty; warps 0 and 1 take part.
constexpr int kSlots = 4;
constexpr int kSlotBytes = 256;
// Then 8 bytes a lane of warp 0 where its counter updates go when it has
// none to make (update_if).
constexpr int kRingBytes = kSlots * kSlotBytes * 32;
constexpr int kEncSmemBytes = kSmemBytes + kRingBytes + 32 * 8;  // 182,016
// K2's tree of the 256 nodes' split factors, the 16-word payload window,
// the decoded byte (16 bytes) and 8 bytes a thread for update_if.
constexpr int kTreeOff = kSmemBytes, kWinOff = kTreeOff + 256 * 4, kCurOff = kWinOff + 16 * 4;
constexpr int kJunkOff = kCurOff + 16;
constexpr int kDecSmemBytes = kJunkOff + 256 * 8;  // 152,144
constexpr int kTreeFull = 1, kByteDone = 2;  // K2's named barriers

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

// The range split (high - low) * scale >> 18 as one high product,
// umulhi(high - low, scale << 14), exact as scale < 2^18.  On an H100 a
// dependent IMAD.HI + IADD takes 9 cycles, IMAD.WIDE + SHF + IADD 23.
__device__ __forceinline__ uint32_t split_hi(uint32_t low, uint32_t high, uint32_t scale14) {
    return __umulhi(high - low, scale14);
}

// A node's counter updates with rates 2/4/6 (src/libbz3.c:347-348),
// stored into the tables when `on` and else into junk[0..3]: both
// outcomes of the bit are computed and one selected, and the stores'
// addresses too, so a warp whose lanes code different bits, or of which
// only some lanes update, neither branches nor diverges.
__device__ __forceinline__ int adapt(int v, uint32_t bit, int rate) {
    return bit ? v + ((v ^ 65535) >> rate) : v - (v >> rate);
}
__device__ __forceinline__ void update_if(const Model &m, uint16_t *r1, uint32_t ctx,
                                          const Pred &q, uint32_t bit, bool on,
                                          uint16_t *junk) {
    *(on ? m.c0 + ctx : junk) = (uint16_t)adapt(q.p0, bit, 2);
    *(on ? r1 + ctx : junk + 1) = (uint16_t)adapt(q.p1, bit, 4);
    *(on ? m.c2 + q.sse : junk + 2) = (uint16_t)adapt(q.x1, bit, 6);
    *(on ? m.c2 + q.sse + 1 : junk + 3) = (uint16_t)adapt(q.x2, bit, 6);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
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

// A row's byte history, which every modelling thread tracks: the last
// two bytes and the run counter.
struct History {
    uint32_t c1, c2;
    int32_t run;
};
// The registers of a row: its history, the coder's range, the payload
// offset (the encoder's optr, the decoder's ip) and the decoder's code.
struct EncRegs {
    History h;
    uint32_t low, high;
    int32_t optr;
};
struct DecRegs {
    History h;
    uint32_t low, high, code;
    int32_t ip;
};
__device__ __forceinline__ EncRegs enc_fresh() { return EncRegs{{0, 0, 0}, 0, 0xFFFFFFFFu, 0}; }
__device__ __forceinline__ DecRegs dec_fresh() { return DecRegs{{0, 0, 0}, 0, 0xFFFFFFFFu, 0, 0}; }

// Where a resumable row's registers lie in state[row, kSmemBytes:], as
// int32 words; kRegPtr is the encoder's optr or the decoder's ip.
enum { kRegLow, kRegHigh, kRegPtr, kRegCode, kRegC1, kRegC2, kRegRun };

__device__ __forceinline__ History load_history(const int32_t *regs) {
    return History{(uint32_t)regs[kRegC1], (uint32_t)regs[kRegC2], regs[kRegRun]};
}
__device__ __forceinline__ void store_history(int32_t *regs, const History &h) {
    regs[kRegC1] = (int32_t)h.c1, regs[kRegC2] = (int32_t)h.c2, regs[kRegRun] = h.run;
}

// K1's model warp over the next n steps of a row, read from src (16-byte
// aligned, width bytes readable): lane b (and its copies b + 8, b + 16,
// b + 24) handles bit b of every byte: its split factor and bit go to
// the ring, its node is updated after the byte's reads.
__device__ __forceinline__ void encode_model(const Model &m, uint32_t *ring, const uint8_t *src,
                                             int64_t width, int32_t n, uint32_t lane,
                                             History &h) {
    const uint32_t b = lane & 7u;
    uint16_t *junk = reinterpret_cast<uint16_t *>(ring + kRingBytes / 4) + 4 * lane;
    Reader rd;
    rd.init(src, width);
    uint32_t c1 = h.c1, c2 = h.c2;
    int32_t run = h.run;
    for (int32_t s0 = 0, q = 0; s0 < n; s0 += kSlotBytes, ++q) {
        const int slot = q % kSlots;
        if (q >= kSlots) bar_sync(1 + kSlots + slot, 64);  // the coder is done with it
        uint32_t *dst = ring + slot * kSlotBytes * 8 + b;
        const int32_t cnt = min(kSlotBytes, n - s0);
        for (int32_t i = 0; i < cnt; ++i) {
            const uint32_t c = rd.byte();
            run = c1 == c2 ? run + 1 : 0;
            uint16_t *r1 = m.c1 + (c1 << 8);
            const uint32_t ctx = (256u | c) >> (8 - b);
            const uint32_t bit = (c >> (7 - b)) & 1u;
            const Pred pq = predict(m, r1, m.c1 + (c2 << 8), ctx, run > 2);
            if (lane < 8) dst[i * 8] = pq.scale | bit << 31;
            update_if(m, r1, ctx, pq, bit, lane < 8, junk);
            __syncwarp();
            c2 = c1;
            c1 = c;
        }
        bar_arrive(1 + slot, 64);
    }
    h = History{c1, c2, run};
}

// K1's coder warp over the next n steps, every lane on the same
// registers and writing the same bytes (one store a warp), so that the
// warp never diverges.  Payload byte optr goes to dst[optr] while optr <
// out_width and is counted either way.  When the row ends, the flush
// (src/libbz3.c:426-433) and the payload's length to *out_len.
__device__ __forceinline__ void encode_coder(const uint32_t *ring, uint8_t *dst, int32_t out_width,
                                             int32_t n, uint32_t lane, EncRegs &r, bool ends,
                                             int32_t *out_len) {
    uint32_t low = r.low, high = r.high;
    int32_t optr = r.optr;
    for (int32_t s0 = 0, q = 0; s0 < n; s0 += kSlotBytes, ++q) {
        const int slot = q % kSlots;
        bar_sync(1 + slot, 64);
        const uint4 *src = reinterpret_cast<const uint4 *>(ring + slot * kSlotBytes * 8);
        const int32_t cnt = min(kSlotBytes, n - s0);
        for (int32_t i = 0; i < cnt; ++i) {
            const uint4 h0 = src[2 * i], h1 = src[2 * i + 1];
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
        if (s0 + kSlots * kSlotBytes < n) bar_arrive(1 + kSlots + slot, 64);
    }
    if (ends) {
        for (int j = 0; j < 4; ++j)
            if (optr + j < out_width) dst[optr + j] = (uint8_t)(low >> (24 - 8 * j));
        if (lane == 0) *out_len = optr + 4;
    }
    r.low = low, r.high = high, r.optr = optr;
}

// K1's body, which K3a shares: warp 0 models and warp 1 codes the next n
// steps of a row (src, width as in encode_model; dst, out_width, ends,
// out_len as in encode_coder).  The ring's slots and barriers restart at
// every call.
__device__ __forceinline__ void encode_steps(const Model &m, unsigned char *smem,
                                             const uint8_t *src, int64_t width, uint8_t *dst,
                                             int32_t out_width, int32_t n, uint32_t warp,
                                             uint32_t lane, EncRegs &r, bool ends,
                                             int32_t *out_len) {
    uint32_t *ring = reinterpret_cast<uint32_t *>(smem + kSmemBytes);
    if (warp == 0)
        encode_model(m, ring, src, width, n, lane, r.h);
    else
        encode_coder(ring, dst, out_width, n, lane, r, ends, out_len);
}

// K1: encode row blockIdx.x, in[row, :lens[row]] -> out[row, :out_lens[row]].
// Rows are in_stride bytes apart (a multiple of 16), of which the first
// in_width are the row; lens are clamped to [0, in_width].
// A payload longer than out_width keeps counting (the true length is
// reported) while its writes past out_width are dropped.  Warps 2-7
// only help to initialise the tables.
__global__ void __launch_bounds__(kThreads)
cm_encode_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                 const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
                 int64_t out_stride, int32_t out_width, int32_t *__restrict__ out_lens) {
    extern __shared__ __align__(16) unsigned char smem[];
    init_model(smem);
    const uint32_t warp = threadIdx.x >> 5, lane = threadIdx.x & 31u;
    if (warp > 1) return;
    const Model m = model_at(smem);  // shared-memory pointers: LDS/STS
    const int64_t row = blockIdx.x;
    const int32_t n = clamp_len(lens[row], in_width);
    EncRegs r = enc_fresh();
    encode_steps(m, smem, in + row * in_stride, in_stride, out + row * out_stride, out_width, n,
                 warp, lane, r, true, out_lens + row);
}

// K2's payload reader.  At each byte's start warp 0 stages 16 words of
// the payload, big-endian, from the word that holds code byte ip on
// (bytes past n_in 0), into shared memory: a byte's 8 bits read at most
// 32 code bytes.  At each bit's start peek() takes code bytes ip..ip+3
// from there, so the loads overlap the bit's arithmetic, and shift_in
// shifts the bit's k of them into code.  No branch.  Offsets are
// absolute in the row, so a resumed row starts at its saved ip.
struct CodeIn {
    const uint32_t *src;
    uint32_t *win;
    int32_t n_in, wlast, ip, base;

    // Big-endian word w of the payload, its bytes past n_in 0 (the load
    // stays inside the row's first n_in bytes, or its first word).
    __device__ __forceinline__ uint32_t word(int32_t w) const {
        const int32_t v = n_in - 4 * w;
        const uint32_t x = __byte_perm(__ldg(src + min(w, wlast)), 0, 0x0123);
        return v >= 4 ? x : (v <= 0 ? 0u : x & (0xFFFFFFFFu << (32 - 8 * v)));
    }

    __device__ __forceinline__ void init(const uint8_t *row, int32_t n, uint32_t *window,
                                         int32_t ip0) {
        src = reinterpret_cast<const uint32_t *>(row);
        win = window;
        n_in = n;
        wlast = n > 0 ? (n - 1) >> 2 : 0;
        ip = ip0;
    }

    // The window of the next byte; every lane of warp 0 stores a word
    // (lanes 16-31 the same as 0-15).  The warp syncs before peek().
    __device__ __forceinline__ void stage(uint32_t lane) {
        base = ip & ~3;
        win[lane & 15] = word((base >> 2) + (int32_t)(lane & 15));
    }

    // Code bytes ip..ip+3, big-endian.
    __device__ __forceinline__ uint32_t peek() const {
        const int32_t o = ip - base;
        return __funnelshift_l(win[(o >> 2) + 1], win[o >> 2], 8 * (o & 3));
    }

    // 8 times the code bytes left at ip, at most 4.
    __device__ __forceinline__ int32_t valid8() const { return 8 * min(max(n_in - ip, 0), 4); }

    // code shifted left by sh bits (sh / 8 bytes) with the first sh / 8
    // bytes of next (peek() and valid8() at the bit's start) shifted in.  A
    // byte past n_in adds 0xFFFFFFFF instead (src/libbz3.c:346,437-440):
    // for the last m of the bytes that takes 0x01..01 (m bytes of 1) off
    // what the zero bytes give.
    __device__ __forceinline__ uint32_t shift_in(uint32_t code, uint32_t next, uint32_t sh,
                                                 int32_t e8) {
        const uint32_t m8 = (uint32_t)max((int32_t)sh - e8, 0);
        ip += (int32_t)(sh >> 3);
        return __funnelshift_lc(next, code, sh) - __funnelshift_lc(0x01010101u, 0u, m8);
    }

    // The decoder's first four code bytes, by warp 0 at a row's start.
    __device__ __forceinline__ uint32_t first_code(uint32_t lane) {
        stage(lane);
        __syncwarp();
        const uint32_t code = shift_in(0, peek(), 32, valid8());
        __syncwarp();
        return code;
    }
};

// K2's body, which K3b and K3c share: the CTA decodes the next n bytes of
// a row into dst[0, n) from its payload src[0, n_in), resuming at code
// byte r.ip, or at the row's start (first: the first four code bytes
// are read).  Thread j predicts node j of every byte (thread 0: node 0,
// never visited); the tree holds each node's split factor << 14, ready
// for split_hi.  Every thread carries the history; warp 0 also the
// range, the code and the payload reader.
__device__ __forceinline__ void decode_steps(const Model &m, unsigned char *smem,
                                             const uint8_t *src, int32_t n_in, bool first,
                                             uint8_t *dst, int32_t n, DecRegs &r) {
    uint32_t *tree = reinterpret_cast<uint32_t *>(smem + kTreeOff);
    uint32_t *cur = reinterpret_cast<uint32_t *>(smem + kCurOff);
    const uint32_t node = threadIdx.x, warp = node >> 5;
    uint16_t *junk = reinterpret_cast<uint16_t *>(smem + kJunkOff) + 4 * node;
    const int32_t level = 31 - __clz(node);  // -1 for node 0
    uint32_t low = r.low, high = r.high, code = r.code;
    CodeIn rd;
    if (warp == 0) {
        rd.init(src, n_in, reinterpret_cast<uint32_t *>(smem + kWinOff), r.ip);
        if (first) code = rd.first_code(node);
    }
    uint32_t c1 = r.h.c1, c2 = r.h.c2;
    int32_t run = r.h.run;
    for (int32_t i = 0; i < n; ++i) {
        run = c1 == c2 ? run + 1 : 0;
        uint16_t *r1 = m.c1 + (c1 << 8);
        const uint16_t *r2 = m.c1 + (c2 << 8);
        // every thread predicts the root too (no branch), so warp 0's
        // bit 0 needs no hand-off; both before any store of this byte
        const Pred pq = predict(m, r1, r2, node, run > 2);
        uint32_t s = predict(m, r1, r2, 1, run > 2).scale << 14;
        if (warp == 0) rd.stage(node);
        tree[node] = pq.scale << 14;
        uint32_t c;
        if (warp == 0) {
            __syncwarp();
            uint32_t nd = 1;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                if (b == 4) bar_sync(kTreeFull, kThreads);  // nodes 32-255 are in
                uint2 kids = make_uint2(0, 0);
                if (b < 7) kids = *reinterpret_cast<const uint2 *>(tree + 2 * nd);
                const uint32_t next = rd.peek();
                const int32_t e8 = rd.valid8();
                const uint32_t mid = low + split_hi(low, high, s);
                const uint32_t bit = code <= mid;
                if (bit)
                    high = mid;
                else
                    low = mid + 1;
                const uint32_t sh = renorm_shift(low, high);
                renorm(low, high, sh);
                code = rd.shift_in(code, next, sh, e8);
                nd = 2 * nd + bit;
                s = bit ? kids.y : kids.x;
            }
            c = nd & 255u;
            dst[i] = (uint8_t)c;  // the same byte from every lane: one store
            *cur = c;
            bar_arrive(kByteDone, kThreads);
        } else {
            bar_arrive(kTreeFull, kThreads);
            bar_sync(kByteDone, kThreads);
            c = *cur;
        }
        update_if(m, r1, node, pq, (c >> (7 - level)) & 1u,
                  node != 0 && ((256u | c) >> (8 - level)) == node, junk);
        // node 1's update before every lane's next root; the window's
        // last reads before the next stage
        if (warp == 0) __syncwarp();
        c2 = c1;
        c1 = c;
    }
    r = DecRegs{{c1, c2, run}, low, high, code, rd.ip};
}

// K2: decode out_lens[row] bytes of row blockIdx.x.  Input past
// in_lens[row] (clamped to in_width) reads as 0xFFFFFFFF: an exhausted
// stream shifts in (code << 8) - 1 (src/libbz3.c:346,437-440).
__global__ void __launch_bounds__(kThreads)
cm_decode_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                 const int32_t *__restrict__ in_lens, const int32_t *__restrict__ out_lens,
                 uint8_t *__restrict__ out, int64_t out_stride) {
    extern __shared__ __align__(16) unsigned char smem[];
    init_model(smem);
    const Model m = model_at(smem);  // shared-memory pointers: LDS/STS
    const int64_t row = blockIdx.x;
    const int32_t n = clamp_len(out_lens[row], out_stride);
    DecRegs r = dec_fresh();
    decode_steps(m, smem, in + row * in_stride, clamp_len(in_lens[row], in_width), true,
                 out + row * out_stride, n, r);
}

// K3a: K1 over the steps [start, stop) of row blockIdx.x (start a
// multiple of 16).  The row's tables and registers come from state[row]
// (fresh when start is 0) and go back there when the row runs on past
// stop.  Payload bytes go to their absolute offsets, dropped past
// out_width; the row that ends in this launch is flushed and its true
// length written.  A row that ended in an earlier launch is left alone.
// Warps 2-7 help with the tables and, when the row runs on, wait at the
// spill's __syncthreads() while warps 0-1 code.
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
    const uint32_t warp = threadIdx.x >> 5, lane = threadIdx.x & 31u;
    const bool ends = n <= stop;
    if (warp > 1 && ends) return;
    EncRegs r = enc_fresh();
    if (start > 0)
        r = EncRegs{load_history(regs), (uint32_t)regs[kRegLow], (uint32_t)regs[kRegHigh],
                    regs[kRegPtr]};
    if (warp <= 1)
        encode_steps(m, smem, in + row * in_stride + start, in_stride - start,
                     out + row * out_stride, out_width, min(n, stop) - start, warp, lane, r, ends,
                     out_lens + row);
    if (ends) return;
    if (threadIdx.x == 0) store_history(regs, r.h);  // the model warp's
    if (threadIdx.x == 32)                            // the coder warp's
        regs[kRegLow] = (int32_t)r.low, regs[kRegHigh] = (int32_t)r.high, regs[kRegPtr] = r.optr;
    spill_model(smem, st);  // after the model warp's last updates
}

// K3b (out_rel 0) and K3c (out_rel 1): K2 over the steps [start, stop)
// of row blockIdx.x, with state as in K3a.  K3b writes decoded byte i at
// out[row, i]; K3c at out[row, i - start] of a [rows, stop - start]
// buffer.  Rows decode out_lens[row] bytes, clamped to out_width.  The
// first four code bytes are read in the first launch; a later launch
// resumes the payload window at the saved ip.
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
    DecRegs r = dec_fresh();
    if (start > 0)
        r = DecRegs{load_history(regs), (uint32_t)regs[kRegLow], (uint32_t)regs[kRegHigh],
                    (uint32_t)regs[kRegCode], regs[kRegPtr]};
    decode_steps(m, smem, in + row * in_stride, clamp_len(in_lens[row], in_width), start == 0,
                 out + row * out_stride + (out_rel ? 0 : start), min(n, stop) - start, r);
    if (n <= stop) return;
    if (threadIdx.x == 0) {
        store_history(regs, r.h);
        regs[kRegLow] = (int32_t)r.low, regs[kRegHigh] = (int32_t)r.high;
        regs[kRegCode] = (int32_t)r.code, regs[kRegPtr] = r.ip;
    }
    spill_model(smem, st);  // after every thread's last updates
}

}  // namespace

// Launchers with a plain C interface.  Each returns the cudaError_t of
// its launch (0 on success): a launch the runtime refuses never runs.

extern "C" int bz3t_cm_encode(const uint8_t *in, int64_t in_stride, int64_t in_width,
                              const int32_t *lens, uint8_t *out, int64_t out_stride,
                              int32_t out_width, int32_t *out_lens, int32_t rows,
                              void *stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kEncSmemBytes);
    if (e != cudaSuccess) return (int)e;
    cm_encode_kernel<<<rows, kThreads, kEncSmemBytes, (cudaStream_t)stream>>>(
        in, in_stride, in_width, lens, out, out_stride, out_width, out_lens);
    return (int)cudaGetLastError();
}

extern "C" int bz3t_cm_decode(const uint8_t *in, int64_t in_stride, int64_t in_width,
                              const int32_t *in_lens, const int32_t *out_lens, uint8_t *out,
                              int64_t out_stride, int32_t rows, void *stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDecSmemBytes);
    if (e != cudaSuccess) return (int)e;
    cm_decode_kernel<<<rows, kThreads, kDecSmemBytes, (cudaStream_t)stream>>>(
        in, in_stride, in_width, in_lens, out_lens, out, out_stride);
    return (int)cudaGetLastError();
}

extern "C" int bz3t_cm_encode_resume(const uint8_t *in, int64_t in_stride, int64_t in_width,
                                     const int32_t *lens, uint8_t *out, int64_t out_stride,
                                     int32_t out_width, int32_t *out_lens, uint8_t *state,
                                     int32_t start, int32_t stop, int32_t rows, void *stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_encode_resume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kEncSmemBytes);
    if (e != cudaSuccess) return (int)e;
    cm_encode_resume_kernel<<<rows, kThreads, kEncSmemBytes, (cudaStream_t)stream>>>(
        in, in_stride, in_width, lens, out, out_stride, out_width, out_lens, state, start, stop);
    return (int)cudaGetLastError();
}

extern "C" int bz3t_cm_decode_resume(const uint8_t *in, int64_t in_stride, int64_t in_width,
                                     const int32_t *in_lens, const int32_t *out_lens,
                                     int32_t out_width, uint8_t *out, int64_t out_stride,
                                     int32_t out_rel, uint8_t *state, int32_t start,
                                     int32_t stop, int32_t rows, void *stream) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_decode_resume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDecSmemBytes);
    if (e != cudaSuccess) return (int)e;
    cm_decode_resume_kernel<<<rows, kThreads, kDecSmemBytes, (cudaStream_t)stream>>>(
        in, in_stride, in_width, in_lens, out_lens, out_width, out, out_stride, out_rel, state,
        start, stop);
    return (int)cudaGetLastError();
}

// Bytes of one row's state for the resumable kernels.
extern "C" int64_t bz3t_cm_state_bytes() { return kStateBytes; }

extern "C" const char *bz3t_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
