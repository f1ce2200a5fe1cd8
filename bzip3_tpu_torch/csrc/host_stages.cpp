// Host pre/post passes of the BZ3v1 block pipeline: CRC32-C, mRLE and
// LZP (reference semantics: src/libbz3.c:37-329; oracles in the JAX
// package's ops/ref).  A copy of the stage codecs of the repository's
// native runtime (csrc/bz3n.cpp), kept inside the PyTorch port so the
// port builds and loads its own library.  Plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -fPIC -shared host_stages.cpp

#include <cstdint>
#include <cstring>

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef int32_t s32;
typedef uint64_t u64;

// ---------------------------------------------------------------- crc32
// Reflected CRC-32C, init 1, no final xor (reference: src/libbz3.c:37-72).

static u32 crc_table[256];
static void crc_init() {
    for (u32 i = 0; i < 256; i++) {
        u32 c = i;
        for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        crc_table[i] = c;
    }
}

extern "C" u32 bz3h_crc32(const u8 *buf, s32 n) {
    u32 c = 1;
    s32 i = 0;
#ifdef __SSE4_2__
    // The x86 crc32 instruction IS the reflected-CRC-32C byte update
    // (same polynomial, no xor in/out), so the table loop and this
    // path return identical values for any (init, data).
    u64 c64 = c;
    for (; i + 8 <= n; i += 8) {
        u64 w;
        __builtin_memcpy(&w, buf + i, 8);
        c64 = __builtin_ia32_crc32di(c64, w);
    }
    c = (u32)c64;
#endif
    for (; i < n; i++) c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c;
}

// ---------------------------------------------------------------- RLE
// mRLE: gain-gated per-byte-value run coding (see ops/ref/rle.py;
// reference semantics at src/libbz3.c:259-329).

static s32 rle_encode(const u8 *in, s32 n, u8 *out, s32 out_cap) {
    int64_t t[256];
    memset(t, 0, sizeof t);
    // pass 1: gains — run starts cost 1, repeats gain 1 except every
    // 255th repeat (which needs a continuation byte).  Per-run form
    // t[c] += reps - reps/255 - 1 decomposes exactly per BYTE: a run
    // start contributes -1, each continuation +1, and every 255th
    // continuation within a run an extra -1 — so the pass is a
    // branch-light histogram (4 sub-histograms break the same-slot
    // store-forward chain on long runs) instead of a nested run scan.
    if (n > 0) {
        int64_t t4[4][256];
        memset(t4, 0, sizeof t4);
        t4[0][in[0]] -= 1;
        u32 cnt = 0;
        for (s32 i = 1; i < n; i++) {
            const int same = in[i] == in[i - 1];
            t4[i & 3][in[i]] += 2 * same - 1;
            cnt = same ? cnt + 1 : 0;
            if (cnt == 255) {  // 255th repeat: continuation byte cost
                t4[0][in[i]] -= 1;
                cnt = 0;
            }
        }
        for (int c = 0; c < 256; c++)
            t[c] = t4[0][c] + t4[1][c] + t4[2][c] + t4[3][c];
    }
    if (out_cap < 32) return -1;
    s32 op = 0;
    for (s32 i = 0; i < 32; i++) {
        u8 b = 0;
        for (s32 j = 0; j < 8; j++)
            if (t[i * 8 + j] > 0) b |= (u8)(1 << j);
        out[op++] = b;
    }
    s32 i = 0;
    while (i < n) {
        u8 c = in[i];
        if (t[c] > 0) {
            s32 j = i + 1;
            while (j < n && in[j] == c) j++;
            s32 run = j - i;
            if (op + 2 > out_cap) return -1;
            out[op++] = c;
            while (run > 255) {
                if (op >= out_cap) return -1;
                out[op++] = 255;
                run -= 255;
            }
            if (op >= out_cap) return -1;
            out[op++] = (u8)(run - 1);
            i = j;
        } else {
            // Ungated byte values pass through verbatim, so a maximal
            // ungated stretch is one bounds check + one memcpy instead
            // of a memset per run (runs are ~1 byte on text).
            s32 j = i + 1;
            while (j < n && t[in[j]] <= 0) j++;
            if (op + (j - i) > out_cap) return -1;
            memcpy(out + op, in + i, (size_t)(j - i));
            op += j - i;
            i = j;
        }
    }
    return op;
}

static s32 rle_decode(const u8 *in, s32 n, u8 *out, s32 out_len) {
    if (n < 32) return -1;
    bool gate[256];
    for (s32 i = 0; i < 32; i++)
        for (s32 j = 0; j < 8; j++) gate[i * 8 + j] = (in[i] >> j) & 1;
    s32 ip = 32, op = 0;
    while (op < out_len && ip < n) {
        u8 c = in[ip++];
        if (gate[c]) {
            int64_t run = 0;
            s32 pc = -1;
            while (ip < n) {
                pc = in[ip++];
                if (pc != 255) break;
                run += 255;
            }
            run += pc + 1;
            int64_t take = run;
            if (take > out_len - op) take = out_len - op;
            memset(out + op, c, (size_t)take);
            op += (s32)take;
        } else {
            out[op++] = c;
        }
    }
    return op == out_len ? op : -1;
}

// ---------------------------------------------------------------- LZP
// Hash-predicted matching (see ops/ref/lzp.py; reference semantics at
// src/libbz3.c:84-257).

#define LZP_BITS 18
#define LZP_MASK ((1 << LZP_BITS) - 1)
#define LZP_MIN_MATCH 40
#define LZP_TOKEN 0xF2

static inline u32 lzp_hash(u32 ctx) { return ((ctx >> 15) ^ ctx ^ (ctx >> 3)) & LZP_MASK; }

static inline u32 ctx_at(const u8 *b, s32 i) {
    return (u32)b[i - 1] | ((u32)b[i - 2] << 8) | ((u32)b[i - 3] << 16) | ((u32)b[i - 4] << 24);
}

// The format pins the hash, the 40-byte threshold, the word-granular
// extension with its +0..3 byte tail, and the `heur` rejection window
// (our encoder must emit byte-identical streams); the phrasing below —
// cursor/emit naming, the literal helper, the early-out shape — is this
// engine's own.

static inline s32 lzp_emit_literal(const u8 *src, s32 *rp, u8 *dst, s32 wp,
                                   u32 *hist, bool escape) {
    const u8 ch = src[(*rp)++];
    dst[wp++] = ch;
    *hist = (*hist << 8) | ch;
    if (escape && ch == LZP_TOKEN) dst[wp++] = 255;
    return wp;
}

static s32 lzp_encode(const u8 *src, s32 n, u8 *dst, s32 *lut) {
    if (n < LZP_MIN_MATCH + 32) return -1;
    memset(lut, 0, sizeof(s32) << LZP_BITS);
    const s32 wp_cap = n - 8;
    const s32 tail_mark = n - LZP_MIN_MATCH - 32;

    memcpy(dst, src, 4);
    s32 wp = 4, rp = 4;
    u32 hist = ctx_at(src, rp);
    s32 probe = 0;  // high-water mark of failed extension scans

    while (rp < tail_mark && wp < wp_cap) {
        const u32 slot = lzp_hash(hist);
        const s32 cand = lut[slot];
        lut[slot] = rp;
        if (cand <= 0) {
            wp = lzp_emit_literal(src, &rp, dst, wp, &hist, false);
            continue;
        }
        // A candidate counts only if both the head word and the word at
        // the 40-byte mark already agree — and the probe window has not
        // previously disproven this region.
        bool take = false;
        s32 mlen = 0;
        if (!memcmp(src + rp + LZP_MIN_MATCH - 4, src + cand + LZP_MIN_MATCH - 4, 4) &&
            !memcmp(src + rp, src + cand, 4) &&
            !(probe > rp && memcmp(src + probe, src + cand + probe - rp, 4))) {
            mlen = 4;
            while (rp + mlen < tail_mark && !memcmp(src + rp + mlen, src + cand + mlen, 4))
                mlen += 4;
            if (mlen >= LZP_MIN_MATCH) {
                take = true;
            } else if (probe < rp + mlen) {
                probe = rp + mlen;
            }
        }
        if (!take) {
            wp = lzp_emit_literal(src, &rp, dst, wp, &hist, true);
            continue;
        }
        for (int k = 0; k < 3; k++)
            if (src[rp + mlen] == src[cand + mlen]) mlen++;
        rp += mlen;
        hist = ctx_at(src, rp);
        dst[wp++] = LZP_TOKEN;
        s32 surplus = mlen - LZP_MIN_MATCH;
        while (surplus >= 254) {
            surplus -= 254;
            dst[wp++] = 254;
            if (wp >= wp_cap) break;
        }
        dst[wp++] = (u8)surplus;
    }

    hist = ctx_at(src, rp);
    while (rp < n && wp < wp_cap) {
        const u32 slot = lzp_hash(hist);
        const bool seen = lut[slot] > 0;
        lut[slot] = rp;
        wp = lzp_emit_literal(src, &rp, dst, wp, &hist, seen);
    }
    return wp >= wp_cap ? -1 : wp;
}

static s32 lzp_decode(const u8 *src, s32 n, u8 *dst, s32 max_out, s32 *lut) {
    if (n < 4) return -1;
    memset(lut, 0, sizeof(s32) << LZP_BITS);
    memcpy(dst, src, 4);
    s32 wp = 4, rp = 4;
    u32 hist = (u32)dst[3] | ((u32)dst[2] << 8) | ((u32)dst[1] << 16) | ((u32)dst[0] << 24);

    while (rp < n && wp < max_out) {
        const u32 slot = lzp_hash(hist);
        const s32 cand = lut[slot];
        lut[slot] = wp;
        if (src[rp] != LZP_TOKEN || cand <= 0) {
            const u8 ch = src[rp++];
            dst[wp++] = ch;
            hist = (hist << 8) | ch;
            continue;
        }
        if (++rp == n) return -1;
        if (src[rp] == 255) {  // escaped literal token
            rp++;
            dst[wp++] = LZP_TOKEN;
            hist = (hist << 8) | LZP_TOKEN;
            continue;
        }
        s32 mlen = LZP_MIN_MATCH;
        for (;;) {
            if (rp == n) return -1;
            const u8 ch = src[rp++];
            mlen += ch;
            if (ch != 254) break;
        }
        s32 from = cand;
        s32 stop = wp + mlen;
        if (stop > max_out) stop = max_out;
        while (wp < stop) dst[wp++] = dst[from++];
        hist = (u32)dst[wp - 1] | ((u32)dst[wp - 2] << 8) |
               ((u32)dst[wp - 3] << 16) | ((u32)dst[wp - 4] << 24);
    }
    return wp;
}


extern "C" s32 bz3h_lzp_encode(const u8 *in, s32 n, u8 *out, s32 *lut) {
    return lzp_encode(in, n, out, lut);
}
extern "C" s32 bz3h_lzp_decode(const u8 *in, s32 n, u8 *out, s32 max_out, s32 *lut) {
    return lzp_decode(in, n, out, max_out, lut);
}
extern "C" s32 bz3h_rle_encode(const u8 *in, s32 n, u8 *out, s32 out_cap) {
    return rle_encode(in, n, out, out_cap);
}
extern "C" s32 bz3h_rle_decode(const u8 *in, s32 n, u8 *out, s32 out_len) {
    return rle_decode(in, n, out, out_len);
}

static struct Init { Init() { crc_init(); } } _init;
