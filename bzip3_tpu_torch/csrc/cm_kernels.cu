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
//   cannot run ahead across bytes; it predicts every byte the current one
//   may still become.  Warp 0 walks the 8 bits and nothing else: each bit
//   the split, the compare with code, the renorm, and two LDS issued while
//   the bit is coded, the next code bytes (from a ring of the payload whose
//   entry p holds bytes p..p+3) and both children's split factors.  Its
//   loads never touch global memory and it predicts nothing.  Thirteen
//   helper warps keep the factors ahead of it.  Warps 1-8 predict nodes
//   16-255 of the byte into a 256-word tree once the byte before is known.
//   Warps 9, 10 and 11-13 predict the next byte's root, nodes 2-3 and
//   nodes 4-15 for each candidate byte (32, 16 and 8 of them) once warp 0
//   has walked bits 0-2, 0-3 and 0-4.  Warp 10 also fills the ring.  So no
//   node prediction and no global load sits between two bytes: at bit 7
//   warp 0 picks the next root from the two candidates left.  A
//   speculating warp owns its nodes: it predicts them for the byte as it
//   stands, and once their bits are walked one lane a node updates them,
//   before the candidates read them.  Each hand-off is a named barrier
//   with warp 0: it arrives after bits 2, 3 and 4 (kBits3-5, the node
//   reached in pref) and after bit 7 (kByteDone, the byte and ip in cur),
//   and it syncs before the loads that need the helpers (kPairIn at the
//   byte's start, kLowIn at bit 1, kTreeFull at bit 3, kRootIn at bit 7).
//   Bound: the coder chain, ~63 cycles a bit; warp 0 alone runs its walk
//   in ~82, and the barriers and the helpers' work beside it bring that to
//   ~128 (PERF.md, section 6).
// Neither coder branches or diverges per bit: every lane of a coder warp
// runs the same registers and stores the same bytes, the counter updates
// select between both outcomes and their addresses, and K2's walk takes a
// uniform branch only per byte, to a copy without the exhaustion rule
// while 32 code bytes are left.  The split is one IMAD.HI (split_hi).
// What is left on a bit's path: the split, the select of low/high, the
// renorm count (FLO) and the shifts; in K2 also the compare with code and
// the pick of the child's factor.
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

#include "cm_coder.cuh"  // split_hi, adapt, renorm_shift, renorm

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
// K2's tree of the 256 nodes' split factors, the next byte's candidates
// (the root's 32, nodes 2-3's 16 pairs, nodes 4-15's 8 rows of 16 words),
// the payload ring of 256 words, the decoded byte and ip (two slots, by
// the byte's parity), the nodes walked after bits 2-4, and 8 bytes a
// thread for update_if.
constexpr int kTreeOff = kSmemBytes, kRingOff = kTreeOff + (256 + 32 + 32 + 128) * 4;
constexpr int kJunkOff = kRingOff + (256 + 4 + 4) * 4;
constexpr int kDecWarps = 14, kDecThreads = 32 * kDecWarps;  // K2's warps (decode_steps)
constexpr int kDecSmemBytes = kJunkOff + kDecThreads * 8;  // 155,424

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

// A node's counter updates (adapt, cm_coder.cuh) with rates 2/4/6
// (src/libbz3.c:347-348), stored into the tables when `on` and else
// into junk[0..3]: both outcomes of the bit are computed and one
// selected, and the stores' addresses too, so a warp whose lanes code
// different bits, or of which only some lanes update, neither branches
// nor diverges.
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

// K2's payload ring.  Entry p % 256 holds code bytes p .. p+3 big-endian
// (bytes past n_in 0), so that a bit's peek is one LDS at 4 * ip masked.
// The ring warp writes 32 entries ahead when the ring holds fewer than
// 128 past ip; warp 0 only reads.
struct Payload {
    const uint32_t *src;
    int32_t n_in, wlast;

    __device__ __forceinline__ void init(const uint8_t *row, int32_t n) {
        src = reinterpret_cast<const uint32_t *>(row);
        n_in = n;
        wlast = n > 0 ? (n - 1) >> 2 : 0;
    }

    // Big-endian word w of the payload, its bytes past n_in 0 (the load
    // stays inside the row's first n_in bytes, or its first word).
    __device__ __forceinline__ uint32_t word(int32_t w) const {
        const int32_t v = n_in - 4 * w;
        const uint32_t x = __byte_perm(__ldg(src + min(w, wlast)), 0, 0x0123);
        return v >= 4 ? x : (v <= 0 ? 0u : x & (0xFFFFFFFFu << (32 - 8 * v)));
    }

    // Code bytes p .. p+3.
    __device__ __forceinline__ uint32_t entry(int32_t p) const {
        return __funnelshift_l(word((p >> 2) + 1), word(p >> 2), 8 * (p & 3));
    }
};

// 8 times the code bytes left at ip, at most 4.
__device__ __forceinline__ int32_t valid8(int32_t n_in, int32_t ip) {
    return 8 * min(max(n_in - ip, 0), 4);
}

// Node k's split factor << 14 as the byte after this one predicts it if
// this one is cand: prev is this byte's c1, run its run counter.
__device__ __forceinline__ uint32_t predict_next(const Model &m, uint32_t k, uint32_t cand,
                                                 uint32_t prev, int32_t run) {
    const uint32_t f = (cand == prev ? run + 1 : 0) > 2;
    return predict(m, m.c1 + (cand << 8), m.c1 + (prev << 8), k, f).scale << 14;
}

// K2's warps.  Warp 0 walks and does nothing else; the rest predict:
// warps 1-8 node (thread - 32) of each byte into the tree (nodes 16-255
// are read, and updated, from there); warp 9 the next byte's root for its
// 32 candidates once warp 0 has walked 3 bits; warp 10 nodes 2-3 for 16
// candidates after 4 bits, and fills the payload ring; warps 11-13 nodes
// 4-15 for 8 candidates after 5 bits.  A speculating warp owns its nodes:
// it predicts them for the byte as it stands, and once their bits are
// walked one lane a node updates it, so the candidates read the tables
// as the next byte will.
constexpr int kRootWarp = 9, kPairWarp = 10, kLowWarp = 11;
// Named barriers a byte, with warp 0 (arrive: it hands over; sync: it
// waits) and their thread counts.
enum { kTreeFull = 1, kByteDone, kBits3, kBits4, kBits5, kRootIn, kPairIn, kLowIn };
constexpr int kTreeCount = 32 + 256, kDoneCount = kDecThreads, kRootCount = 64,
              kPairCount = 64, kLowCount = 32 + 96;

// One byte of a speculating warp, whose lane predicts node k for the
// byte (r1, r2, run as it stands) and then, once warp 0 has walked bits
// 0..b (nd, from pref), has node k updated by lane upd and predicts it for
// the next byte if that is the candidate whose last 7 - b bits are x,
// into *out.  in_bar / out_bar are its hand-offs with warp 0.
__device__ __forceinline__ void speculate_byte(const Model &m, const uint32_t *pref, uint32_t k,
                                               uint32_t x, int b, int in_bar, int out_bar,
                                               int count, bool upd, uint32_t *out,
                                               uint16_t *r1, const uint16_t *r2, uint32_t c1,
                                               int32_t run, uint16_t *junk) {
    const Pred pq = predict(m, r1, r2, k, run > 2);
    bar_sync(in_bar, count);
    const uint32_t nd = *pref;
    const int32_t level = 31 - __clz(k);
    update_if(m, r1, k, pq, (nd >> (b - level)) & 1u, upd && (nd >> (b + 1 - level)) == k, junk);
    __syncwarp();  // the update before the candidates read node k
    const uint32_t cand = ((nd & ((2u << b) - 1)) << (7 - b)) | x;
    *out = predict_next(m, k, cand, c1, run);
    bar_arrive(out_bar, count);
}

// Warp 0's registers: the range, the code, the root's factor, 4 * ip.
struct Walk {
    uint32_t low, high, code, s, ip4;
};

// One byte of warp 0's walk.  Fast: the payload holds 32 bytes past ip,
// so no bit of the byte runs out of input and the exhaustion rule is
// left out.  Each bit: the split at s, the compare with code, the renorm,
// the shift of code bytes ip.. (one LDS from the ring) into code, and s
// from the children's factors loaded while the bit is coded: nodes 2-3
// and 4-15 from the candidates of this byte's c1, 16-255 from the tree,
// the next root from its two candidates left after bit 6.  After bits 2,
// 3 and 4 the node reached goes to pref and its warps are let go.
template <bool kFast>
__device__ __forceinline__ uint32_t walk_byte(const uint32_t *tree, const uint32_t *roots,
                                              const uint32_t *pairs, const uint32_t *lows,
                                              const uint32_t *ring, uint32_t *pref,
                                              uint32_t *cur, int32_t n_in, uint32_t c1,
                                              bool later, uint8_t *out, Walk &w) {
    const unsigned char *rb = reinterpret_cast<const unsigned char *>(ring);
    const uint32_t *lo = lows + 16 * (c1 & 7u);
    uint32_t low = w.low, high = w.high, code = w.code, s = w.s, ip4 = w.ip4, nd = 1;
    uint2 kids;
    if (later) bar_sync(kPairIn, kPairCount);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
        if (b == 0) kids = *reinterpret_cast<const uint2 *>(pairs + 2 * (c1 & 15u));
        if (b == 1 && later) bar_sync(kLowIn, kLowCount);
        if (b == 1 || b == 2) kids = *reinterpret_cast<const uint2 *>(lo + 2 * nd);
        if (b == 3) bar_sync(kTreeFull, kTreeCount);
        if (b >= 3 && b < 7) kids = *reinterpret_cast<const uint2 *>(tree + 2 * nd);
        if (b == 7) {
            bar_sync(kRootIn, kRootCount);
            kids = *reinterpret_cast<const uint2 *>(roots + 2 * (nd & 15u));
        }
        const uint32_t next = *reinterpret_cast<const uint32_t *>(rb + (ip4 & 1020u));
        const int32_t e8 = kFast ? 32 : valid8(n_in, (int32_t)(ip4 >> 2));
        const uint32_t mid = low + split_hi(low, high, s);
        const uint32_t bit = code <= mid;
        if (bit)
            high = mid;
        else
            low = mid + 1;
        const uint32_t sh = renorm_shift(low, high);
        renorm(low, high, sh);
        // a byte past n_in shifts in 0xFF (src/libbz3.c:346,437-440): for
        // the last m of those taken, 0x01..01 (m bytes of 1) off the 0s
        code = __funnelshift_lc(next, code, sh);
        if (!kFast) code -= __funnelshift_lc(0x01010101u, 0u, (uint32_t)max((int32_t)sh - e8, 0));
        ip4 += sh >> 1;
        nd = 2 * nd + bit;
        s = bit ? kids.y : kids.x;
        if (b == 2) pref[0] = nd, bar_arrive(kBits3, kRootCount);
        if (b == 3) pref[1] = nd, bar_arrive(kBits4, kPairCount);
        if (b == 4) pref[2] = nd, bar_arrive(kBits5, kLowCount);
    }
    const uint32_t c = nd & 255u;
    *out = (uint8_t)c;  // the same byte from every lane: one store
    *reinterpret_cast<uint2 *>(cur) = make_uint2(c, ip4 >> 2);
    bar_arrive(kByteDone, kDoneCount);
    w = Walk{low, high, code, s, ip4};
    return c;
}

// K2's body, which K3b and K3c share: the CTA decodes the next n bytes of
// a row into dst[0, n) from its payload src[0, n_in), resuming at code
// byte r.ip, or at the row's start (first: the first four code bytes
// are read).  The tree holds each node's split factor << 14, ready for
// split_hi; the candidates' factors too.  Every warp carries the history;
// warp 0 also the range and the code.
__device__ __forceinline__ void decode_steps(const Model &m, unsigned char *smem,
                                             const uint8_t *src, int32_t n_in, bool first,
                                             uint8_t *dst, int32_t n, DecRegs &r) {
    uint32_t *tree = reinterpret_cast<uint32_t *>(smem + kTreeOff);
    uint32_t *roots = tree + 256, *pairs = roots + 32, *lows = pairs + 32;
    uint32_t *ring = reinterpret_cast<uint32_t *>(smem + kRingOff);
    uint32_t *cur = ring + 256, *pref = cur + 4;
    const uint32_t tid = threadIdx.x, warp = tid >> 5, lane = tid & 31u;
    uint16_t *junk = reinterpret_cast<uint16_t *>(smem + kJunkOff) + 4 * tid;
    Payload pl;
    pl.init(src, n_in);
    // this warp's speculated node and candidate, and where they go
    uint32_t k = 1, x = lane, *out = roots + lane;
    if (warp == kPairWarp) k = 2 + (lane >> 4), x = lane & 15u, out = pairs + 2 * x + k - 2;
    if (warp >= kLowWarp) {
        const uint32_t t = tid - 32 * kLowWarp;
        k = 4 + (t >> 3), x = t & 7u, out = lows + 16 * x + k;
    }
    // the next ring entry the ring warp writes
    int32_t hi = r.ip + 160;
    if (warp == kPairWarp)
        for (int32_t p = r.ip + (int32_t)lane; p < hi; p += 32) ring[p & 255] = pl.entry(p);
    if (warp >= kRootWarp) *out = predict_next(m, k, r.h.c1, r.h.c2, r.h.run);
    __syncthreads();
    Walk w{r.low, r.high, r.code, roots[0], 4u * (uint32_t)r.ip};
    if (first) {  // the first four code bytes
        const uint32_t m8 = (uint32_t)max(32 - valid8(n_in, r.ip), 0);
        w.code = ring[r.ip & 255] - __funnelshift_lc(0x01010101u, 0u, m8);
        w.ip4 += 16;
    }
    int32_t ip = (int32_t)(w.ip4 >> 2);
    uint32_t c1 = r.h.c1, c2 = r.h.c2;
    int32_t run = r.h.run;
    for (int32_t i = 0; i < n; ++i) {
        run = c1 == c2 ? run + 1 : 0;
        uint16_t *r1 = m.c1 + (c1 << 8);
        const uint16_t *r2 = m.c1 + (c2 << 8);
        uint32_t *cur_i = cur + 2 * (i & 1);
        uint32_t c;
        if (warp == 0) {
            if (n_in - (int32_t)(w.ip4 >> 2) >= 32)
                c = walk_byte<true>(tree, roots, pairs, lows, ring, pref, cur_i, n_in, c1, i > 0,
                                    dst + i, w);
            else
                c = walk_byte<false>(tree, roots, pairs, lows, ring, pref, cur_i, n_in, c1, i > 0,
                                     dst + i, w);
        } else {
            if (warp <= 8) {
                const uint32_t node = tid - 32;
                const int32_t level = 31 - __clz(node);
                const Pred pq = predict(m, r1, r2, node, run > 2);
                tree[node] = pq.scale << 14;
                bar_arrive(kTreeFull, kTreeCount);
                bar_sync(kByteDone, kDoneCount);
                c = cur_i[0];
                update_if(m, r1, node, pq, (c >> (7 - level)) & 1u,
                          node >= 16 && ((256u | c) >> (8 - level)) == node, junk);
            } else {
                if (warp == kRootWarp)
                    speculate_byte(m, pref, k, x, 2, kBits3, kRootIn, kRootCount, lane == 0, out,
                                   r1, r2, c1, run, junk);
                else if (warp == kPairWarp)
                    speculate_byte(m, pref + 1, k, x, 3, kBits4, kPairIn, kPairCount, x == 0,
                                   out, r1, r2, c1, run, junk);
                else
                    speculate_byte(m, pref + 2, k, x, 4, kBits5, kLowIn, kLowCount, x == 0, out,
                                   r1, r2, c1, run, junk);
                if (warp == kPairWarp && hi < ip + 128) {
                    // entries seen by warp 0 two bytes on, past what it reads
                    ring[(hi + (int32_t)lane) & 255] = pl.entry(hi + (int32_t)lane);
                    hi += 32;
                }
                bar_sync(kByteDone, kDoneCount);
                c = cur_i[0];
                ip = (int32_t)cur_i[1];
            }
        }
        c2 = c1;
        c1 = c;
    }
    if (warp == 0 && n > 0) {  // the last byte's candidates are not read
        bar_sync(kPairIn, kPairCount);
        bar_sync(kLowIn, kLowCount);
    }
    r = DecRegs{{c1, c2, run}, w.low, w.high, w.code, (int32_t)(w.ip4 >> 2)};
}

// K2: decode out_lens[row] bytes of row blockIdx.x.  Input past
// in_lens[row] (clamped to in_width) reads as 0xFFFFFFFF: an exhausted
// stream shifts in (code << 8) - 1 (src/libbz3.c:346,437-440).
__global__ void __launch_bounds__(kDecThreads)
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
__global__ void __launch_bounds__(kDecThreads)
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
    cm_decode_kernel<<<rows, kDecThreads, kDecSmemBytes, (cudaStream_t)stream>>>(
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
    cm_decode_resume_kernel<<<rows, kDecThreads, kDecSmemBytes, (cudaStream_t)stream>>>(
        in, in_stride, in_width, in_lens, out_lens, out_width, out, out_stride, out_rel, state,
        start, stop);
    return (int)cudaGetLastError();
}

// Bytes of one row's state for the resumable kernels.
extern "C" int64_t bz3t_cm_state_bytes() { return kStateBytes; }

extern "C" const char *bz3t_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
