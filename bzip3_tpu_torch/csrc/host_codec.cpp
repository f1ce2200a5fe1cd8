// Host block codec of the BZ3v1 format: the CM range coder, one block's
// encode and decode, and a pthread pool over a batch of blocks (the
// port's native engine; reference semantics src/libbz3.c:331-809 and
// the pool of bz3_encode_blocks / bz3_decode_blocks, :845).  A copy of
// the CM coder, block codec and pool of the repository's native runtime
// (csrc/bz3n.cpp:307-490, :1233-1430, :1606-1749), kept inside the
// PyTorch port so the port builds and loads its own library; its
// paired-decode mode and environment switches are left out.  The CRC,
// RLE and LZP stages (host_stages.cpp) and the BWT (host_bwt.cpp) are
// called through their C entry points: the three sources link into one
// library.  Plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -fPIC -shared -pthread host_stages.cpp
//        host_bwt.cpp host_codec.cpp

#include <cstdint>
#include <cstring>
#include <pthread.h>
#include <unistd.h>
#include <vector>

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef int32_t s32;
typedef uint64_t u64;

extern "C" {
u32 bz3h_crc32(const u8 *buf, s32 n);
s32 bz3h_rle_encode(const u8 *in, s32 n, u8 *out, s32 out_cap);
s32 bz3h_rle_decode(const u8 *in, s32 n, u8 *out, s32 out_len);
s32 bz3h_lzp_encode(const u8 *in, s32 n, u8 *out, s32 *lut);
s32 bz3h_lzp_decode(const u8 *in, s32 n, u8 *out, s32 max_out, s32 *lut);
s32 bz3h_bwt_forward(const u8 *in, u8 *out, s32 n, s32 *scratch);
s32 bz3h_bwt_inverse(const u8 *in, u8 *out, s32 n, s32 index, s32 *scratch,
                     int64_t scratch_words);
}

#define LZP_BITS 18

// ---------------------------------------------------------------- CM coder
// Context-mixing binary range coder (the JAX package's ops/ref/cm.py;
// reference semantics at src/libbz3.c:331-494).

struct CmState {
    u16 C0[256];
    u16 C1[256][256];
    u16 C2[512][17];
};

static void cm_begin(CmState *s) {
    for (int i = 0; i < 256; i++) s->C0[i] = 1 << 15;
    for (int i = 0; i < 256; i++)
        for (int j = 0; j < 256; j++) s->C1[i][j] = 1 << 15;
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 256; j++)
            for (int k = 0; k < 17; k++)
                s->C2[2 * j + i][k] = (u16)((k << 12) - (k == 16));
}

// The mixing formula, the 2/4/6 learning shifts, the SSE interpolation
// and the carry-free renorm condition are pinned by the format.

struct BitMix {
    int mix;      // blended prediction, 16-bit domain
    int bucket;   // SSE quantization bucket (mix >> 12)
    int o0, a, b; // counters sampled at this node
    int sse_lo, sse_hi;
    u16 *sse_row;
};

static inline BitMix cm_predict(CmState *s, const u16 *row_a, const u16 *row_b,
                                int node, int hot) {
    BitMix m;
    m.o0 = s->C0[node];
    m.a = row_a[node];
    m.b = row_b[node];
    m.mix = ((m.o0 + m.a) * 7 + m.b + m.b) >> 4;
    m.bucket = m.mix >> 12;
    m.sse_row = s->C2[2 * node + hot];
    m.sse_lo = m.sse_row[m.bucket];
    m.sse_hi = m.sse_row[m.bucket + 1];
    return m;
}

static inline u32 cm_span(const BitMix &m, u32 width) {
    const int sse_p = m.sse_lo + (((m.sse_hi - m.sse_lo) * (m.mix & 4095)) >> 12);
    return (u32)(((u64)width * (u32)(sse_p * 3 + m.mix)) >> 18);
}

static inline void cm_learn(CmState *s, u16 *row_w, int node, const BitMix &m, bool one) {
    if (one) {
        s->C0[node] = (u16)(m.o0 + ((m.o0 ^ 65535) >> 2));
        row_w[node] = (u16)(m.a + ((m.a ^ 65535) >> 4));
        m.sse_row[m.bucket] = (u16)(m.sse_lo + ((m.sse_lo ^ 65535) >> 6));
        m.sse_row[m.bucket + 1] = (u16)(m.sse_hi + ((m.sse_hi ^ 65535) >> 6));
    } else {
        s->C0[node] = (u16)(m.o0 - (m.o0 >> 2));
        row_w[node] = (u16)(m.a - (m.a >> 4));
        m.sse_row[m.bucket] = (u16)(m.sse_lo - (m.sse_lo >> 6));
        m.sse_row[m.bucket + 1] = (u16)(m.sse_hi - (m.sse_hi >> 6));
    }
}

static s32 cm_encode(CmState *s, const u8 *buf, s32 size, u8 *out) {
    u32 rhi = 0xFFFFFFFFu, rlo = 0;
    u32 prev1 = 0, prev2 = 0, streak = 0;
    s32 wp = 0;

    for (s32 i = 0; i < size; i++) {
        u8 c = buf[i];
        streak = (prev1 == prev2) ? streak + 1 : 0;
        const int hot = streak > 2;
        const u16 *row_a = s->C1[prev1];
        const u16 *row_b = s->C1[prev2];
        u16 *row_w = s->C1[prev1];

        // exactly 8 descent steps, counted so that the loop unrolls
        int node = 1;
        for (int bit = 0; bit < 8; bit++, c <<= 1) {
            const BitMix m = cm_predict(s, row_a, row_b, node, hot);
            const u32 span = cm_span(m, rhi - rlo);

            if (c & 0x80) {
                rhi = rlo + span;
                while ((rlo ^ rhi) < (1u << 24)) {
                    out[wp++] = (u8)(rlo >> 24);
                    rlo <<= 8;
                    rhi = (rhi << 8) | 0xFF;
                }
                cm_learn(s, row_w, node, m, true);
                node += node + 1;
            } else {
                rlo += span + 1;
                while ((rlo ^ rhi) < (1u << 24)) {
                    out[wp++] = (u8)(rlo >> 24);
                    rlo <<= 8;
                    rhi = (rhi << 8) | 0xFF;
                }
                cm_learn(s, row_w, node, m, false);
                node += node;
            }
        }
        prev2 = prev1;
        prev1 = (u32)(node & 255);
    }
    for (int k = 0; k < 4; k++) {
        out[wp++] = (u8)(rlo >> 24);
        rlo <<= 8;
    }
    return wp;
}

// An exhausted stream shifts in 0xFF bytes: (code << 8) - 1 in u32.
static void cm_decode(CmState *s, const u8 *in, s32 in_len, u8 *out, s32 size) {
    u32 rhi = 0xFFFFFFFFu, rlo = 0, cursor = 0;
    u32 prev1 = 0, prev2 = 0, streak = 0;
    s32 rp = 0;

    for (int k = 0; k < 4; k++)
        cursor = (cursor << 8) + (rp < in_len ? in[rp++] : (u32)-1);

    for (s32 i = 0; i < size; i++) {
        streak = (prev1 == prev2) ? streak + 1 : 0;
        const int hot = streak > 2;
        const u16 *row_a = s->C1[prev1];
        const u16 *row_b = s->C1[prev2];
        u16 *row_w = s->C1[prev1];

        int node = 1;
        for (int bit = 0; bit < 8; bit++) {
            const BitMix m = cm_predict(s, row_a, row_b, node, hot);
            const u32 split = rlo + cm_span(m, rhi - rlo);

            if (cursor <= split) {
                rhi = split;
                while ((rlo ^ rhi) < (1u << 24)) {
                    rlo <<= 8;
                    rhi = (rhi << 8) | 0xFF;
                    cursor = (cursor << 8) + (rp < in_len ? in[rp++] : (u32)-1);
                }
                cm_learn(s, row_w, node, m, true);
                node += node + 1;
            } else {
                rlo = split + 1;
                while ((rlo ^ rhi) < (1u << 24)) {
                    rlo <<= 8;
                    rhi = (rhi << 8) | 0xFF;
                    cursor = (cursor << 8) + (rp < in_len ? in[rp++] : (u32)-1);
                }
                cm_learn(s, row_w, node, m, false);
                node += node;
            }
        }
        prev2 = prev1;
        out[i] = (u8)(prev1 = (u32)(node & 255));
        // Pull the next byte's C1 row toward L1 while this byte's stores
        // retire; only when the context byte changed (BWT output is
        // run-heavy, so rows stay hot within a run).
        if (prev1 != prev2) {
            for (int q = 0; q < 512; q += 64)
                __builtin_prefetch((const char *)s->C1[prev1] + q);
        }
    }
}

// ------------------------------------------------------- block codec

static inline s32 bz3_bound(s32 n) { return n + n / 50 + 32; }

struct Workspace {
    std::vector<u8> swap1, swap2;
    std::vector<s32> sa;
    std::vector<s32> lzp_lut;
    CmState cm;
    void ensure(s32 block_size) {
        size_t cap = (size_t)bz3_bound(block_size) + 64;
        if (swap1.size() < cap) {
            swap1.resize(cap);
            swap2.resize(cap);
            // covers the forward scratch (n + 1 words of SA, then the
            // u8 temp) and both inverse node layouts (u64 nodes: 2(n+2))
            sa.resize(2 * (cap + 16));
        }
        if (lzp_lut.empty()) lzp_lut.resize((size_t)1 << LZP_BITS);
    }
};

static inline void put_u32(u8 *p, u32 v) { memcpy(p, &v, 4); }
static inline u32 get_u32(const u8 *p) { u32 v; memcpy(&v, p, 4); return v; }

// Encode one block into out (bound(n) + 64 bytes): header + payload.
// Returns the output length, or -1 if the BWT failed.
static s32 encode_block_ws(Workspace &ws, const u8 *in, s32 n, u8 *out) {
    const u32 crc = bz3h_crc32(in, n);
    put_u32(out, crc);
    if (n < 64) {
        put_u32(out + 4, (u32)-1);
        memcpy(out + 8, in, n);
        return n + 8;
    }
    ws.ensure(n);
    u8 *b1 = ws.swap1.data();
    u8 *b2 = ws.swap2.data();
    const u8 *cur = in;
    s32 cur_n = n;
    u8 model = 0;
    s32 lzp_size = -1, rle_size = -1;

    s32 r = bz3h_rle_encode(cur, cur_n, b1, cur_n - 1);
    if (r > 0 && r < cur_n) {
        model |= 4;
        rle_size = r;
        cur = b1;
        cur_n = r;
    }
    s32 l = bz3h_lzp_encode(cur, cur_n, b2, ws.lzp_lut.data());
    if (l > 0 && l < cur_n) {
        model |= 2;
        lzp_size = l;
        cur = b2;
        cur_n = l;
    }

    u8 *bwt_out = (cur == b1) ? b2 : b1;
    const s32 idx = bz3h_bwt_forward(cur, bwt_out, cur_n, ws.sa.data());
    if (idx < 0) return -1;
    put_u32(out + 4, (u32)idx);
    out[8] = model;
    s32 off = 9;
    if (model & 2) { put_u32(out + off, (u32)lzp_size); off += 4; }
    if (model & 4) { put_u32(out + off, (u32)rle_size); off += 4; }
    cm_begin(&ws.cm);
    return off + cm_encode(&ws.cm, bwt_out, cur_n, out + off);
}

// Decode one block into out (bound(block_size) + 64 bytes).  Returns
// its length, or an error: -1 BWT, -2 malformed header, -3 CRC or a
// failed stage, -5 a block shorter than its header.
static s32 decode_block_ws(Workspace &ws, const u8 *in, s32 in_len, s32 orig_size,
                           s32 block_size, u8 *out) {
    if (in_len < 8) return -5;
    const s32 cap = bz3_bound(block_size);
    if (in_len > cap || orig_size > cap || orig_size < 0) return -2;
    const u32 crc = get_u32(in);
    const s32 idx = (s32)get_u32(in + 4);
    if (idx == -1) {
        const s32 ln = in_len - 8;
        if (ln > 64) return -2;
        memcpy(out, in + 8, ln);
        return bz3h_crc32(out, ln) == crc ? ln : -3;
    }
    if (in_len < 9) return -5;
    const u8 model = in[8];
    s32 off = 9;
    s32 lzp_size = -1, rle_size = -1;
    if (model & 2) { if (in_len < off + 4) return -5; lzp_size = (s32)get_u32(in + off); off += 4; }
    if (model & 4) { if (in_len < off + 4) return -5; rle_size = (s32)get_u32(in + off); off += 4; }
    if ((model & 2) && (lzp_size < 0 || lzp_size > cap)) return -2;
    if ((model & 4) && (rle_size < 0 || rle_size > cap)) return -2;
    const s32 sbb = (model & 2) ? lzp_size : (model & 4) ? rle_size : orig_size;
    if (idx > sbb || sbb > cap) return -2;

    ws.ensure(block_size);
    u8 *b1 = ws.swap1.data();
    u8 *b2 = ws.swap2.data();
    cm_begin(&ws.cm);
    cm_decode(&ws.cm, in + off, in_len - off, b1, sbb);
    if (bz3h_bwt_inverse(b1, b2, sbb, idx, ws.sa.data(), (int64_t)ws.sa.size()) != 0)
        return -1;
    const u8 *cur = b2;
    s32 cur_n = sbb;
    u8 *other = b1;
    if (model & 2) {
        const s32 r = bz3h_lzp_decode(cur, cur_n, other, cap, ws.lzp_lut.data());
        if (r < 0) return -3;
        cur = other;
        cur_n = r;
        other = (other == b1) ? b2 : b1;
    }
    if (model & 4) {
        const s32 r = bz3h_rle_decode(cur, cur_n, other, orig_size);
        if (r < 0) return -3;
        cur = other;
        cur_n = r;
    }
    if (cur_n > block_size) return -2;
    memcpy(out, cur, cur_n);
    return bz3h_crc32(out, cur_n) == crc ? cur_n : -3;
}

// ------------------------------------------------ public C ABI

// CM stage alone, from a fresh model: out needs size + size/8 + 64 bytes.
extern "C" s32 bz3h_cm_encode(const u8 *in, s32 size, u8 *out) {
    CmState *s = new CmState;
    cm_begin(s);
    const s32 r = cm_encode(s, in, size, out);
    delete s;
    return r;
}

extern "C" void bz3h_cm_decode(const u8 *in, s32 in_len, u8 *out, s32 size) {
    CmState *s = new CmState;
    cm_begin(s);
    cm_decode(s, in, in_len, out, size);
    delete s;
}

// One block on the calling thread (its own workspace, kept per thread).
extern "C" s32 bz3h_encode_block(const u8 *in, s32 n, u8 *out) {
    static thread_local Workspace ws;
    return encode_block_ws(ws, in, n, out);
}

extern "C" s32 bz3h_decode_block(const u8 *in, s32 in_len, s32 orig_size, s32 block_size,
                                 u8 *out) {
    static thread_local Workspace ws;
    return decode_block_ws(ws, in, in_len, orig_size, block_size, out);
}

struct Job {
    const u8 *in;
    s32 in_len;
    s32 orig_size;
    u8 *out;
    s32 result;
};

struct Pool {
    std::vector<Job> jobs;
    bool encode;
    s32 block_size;
    s32 next;
    pthread_mutex_t mu;
};

static void *worker(void *arg) {
    Pool *p = (Pool *)arg;
    Workspace ws;
    for (;;) {
        pthread_mutex_lock(&p->mu);
        const s32 i = p->next < (s32)p->jobs.size() ? p->next++ : -1;
        pthread_mutex_unlock(&p->mu);
        if (i < 0) break;
        Job &j = p->jobs[i];
        j.result = p->encode
                       ? encode_block_ws(ws, j.in, j.in_len, j.out)
                       : decode_block_ws(ws, j.in, j.in_len, j.orig_size, p->block_size, j.out);
    }
    return nullptr;
}

// Run the pool's jobs on n_threads workers (<= 0: one per online core,
// at most 64; never more than the jobs), each with its own workspace.
static void run_pool(Pool &pool, s32 n_threads, s32 *results) {
    const s32 n = (s32)pool.jobs.size();
    if (n_threads <= 0) {
        const long hw = sysconf(_SC_NPROCESSORS_ONLN);
        n_threads = hw > 0 ? (s32)hw : 4;
        if (n_threads > 64) n_threads = 64;
    }
    if (n_threads > n) n_threads = n;
    pool.next = 0;
    pthread_mutex_init(&pool.mu, nullptr);
    std::vector<pthread_t> th(n_threads);
    for (s32 t = 0; t < n_threads; t++) pthread_create(&th[t], nullptr, worker, &pool);
    for (s32 t = 0; t < n_threads; t++) pthread_join(th[t], nullptr);
    pthread_mutex_destroy(&pool.mu);
    for (s32 i = 0; i < n; i++) results[i] = pool.jobs[i].result;
}

// Batch encode: ins[i] has lens[i] bytes; outs[i] must hold
// bound(lens[i]) + 64 bytes.  results[i] = output length or -1.
extern "C" void bz3h_encode_blocks(const u8 **ins, const s32 *lens, u8 **outs,
                                   s32 *results, s32 n, s32 n_threads) {
    Pool pool;
    pool.encode = true;
    pool.block_size = 0;
    for (s32 i = 0; i < n; i++) pool.jobs.push_back(Job{ins[i], lens[i], 0, outs[i], -99});
    run_pool(pool, n_threads, results);
}

// Batch decode of (ins[i], orig_sizes[i]); outs[i] must hold
// bound(block_size) + 64 bytes.  results[i] as bz3h_decode_block.
extern "C" void bz3h_decode_blocks(const u8 **ins, const s32 *in_lens,
                                   const s32 *orig_sizes, s32 block_size, u8 **outs,
                                   s32 *results, s32 n, s32 n_threads) {
    Pool pool;
    pool.encode = false;
    pool.block_size = block_size;
    for (s32 i = 0; i < n; i++)
        pool.jobs.push_back(Job{ins[i], in_lens[i], orig_sizes[i], outs[i], -99});
    run_pool(pool, n_threads, results);
}
