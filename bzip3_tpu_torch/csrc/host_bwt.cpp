// Host BWT of the BZ3v1 block pipeline: SA-IS forward transform and the
// quad-merge inverse, for blocks past the device-block cap (the
// oversize host-BWT hybrid of pipeline.py).  A copy of the BWT stage of
// the repository's native runtime (csrc/bz3n.cpp:492-1230, entry points
// bz3n_bwt_forward and bz3n_bwt_inverse_ex), kept inside the PyTorch port
// so the port builds and loads its own library; its profiling hooks and
// environment switches are left out.  Output contract of libsais_bwt as
// the format uses it (JAX package's ops/ref/bwt.py).  Plain C ABI for
// ctypes.
//
// Build: g++ -O3 -march=native -fPIC -shared host_bwt.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

typedef uint8_t u8;
typedef uint32_t u32;
typedef int32_t s32;
typedef uint64_t u64;

// ---------------------------------------------------------------- SA-IS
// Suffix-array construction by induced sorting, from the algorithm of
// Nong, Zhang & Chan (2009).  The working string is stored COMBINED:
// Tc[j] = (value << 1) | type (type: 1 = S, 0 = L), so the induce
// loops touch one array instead of two and level 0 fits in u16
// (values are byte+1, sentinel 0).  Buckets are keyed on the combined
// value: within equal raw values every L-suffix precedes every
// S-suffix in the suffix array, which is exactly the (value<<1)|type
// order, so combined bucketing is equivalent and branch-free.

template <typename C>
static inline bool is_lms_at(const C *Tc, s32 i) {
    return i > 0 && (Tc[i] & 1) && !(Tc[i - 1] & 1);
}

// Prefetch distance of the induced-sort scans (24: best single-thread
// SA-IS rate of the native runtime's measurements, csrc/bz3n.cpp:31-39).
static constexpr s32 kPrefetch = 24;

// One L-pass then one S-pass of induced sorting over combined buckets.
// EMIT: fused BWT emission in the S-pass.  When the S-pass visits slot
// i (right-to-left) the entry there is final — any placement into i
// happens while the scan is still to its right, because suffix j-1 is
// S-type only if suffix j-1 < suffix j, so --bkt always lands left of
// the visit that induces it (and combined value|type buckets keep L
// slots disjoint from S placements).  The induction already reads
// Tc[SA[i]-1] at every visit, so bwt[i] = raw(Tc[SA[i]-1]) is free —
// this removes the separate random-gather BWT pass entirely (the
// latent idea in libsais' bwt-fused induce, include/libsais.h:3311).
template <typename C, bool EMIT = false>
static void sais_induce(const C *Tc, s32 *SA, s32 n, s32 K2, const s32 *cnt, s32 *bkt,
                        u8 *bwt = nullptr, s32 *prim = nullptr) {
    // Short-distance prefetch of the dependent Tc[SA[i+d]-1] load: in
    // the L-pass entries a few slots ahead are usually already
    // written (either LMS seeds or L-inductions that land forward).
    const s32 PF = kPrefetch;
    // L-pass: bucket starts.
    {
        s32 sum = 0;
        for (s32 c = 0; c < K2; c++) { bkt[c] = sum; sum += cnt[c]; }
        for (s32 i = 0; i < n; i++) {
            if (PF && i + PF < n) {
                s32 jp = SA[i + PF];
                if (jp > 0) __builtin_prefetch(&Tc[jp - 1]);
            }
            s32 j = SA[i];
            if (j > 0) {
                C c = Tc[j - 1];
                if (!(c & 1)) SA[bkt[c]++] = j - 1;
            }
        }
    }
    // S-pass: bucket ends.
    {
        s32 sum = 0;
        for (s32 c = 0; c < K2; c++) { sum += cnt[c]; bkt[c] = sum; }
        for (s32 i = n - 1; i >= 0; i--) {
            if (PF && i - PF >= 0) {
                s32 jp = SA[i - PF];
                if (jp > 0) __builtin_prefetch(&Tc[jp - 1]);
            }
            s32 j = SA[i];
            if (j > 0) {
                C c = Tc[j - 1];
                if (EMIT) bwt[i] = (u8)((c >> 1) - 1);
                if (c & 1) SA[--bkt[c]] = j - 1;
            } else if (EMIT && j == 0) {
                *prim = i;
            }
        }
    }
}

// Per-(thread, recursion-depth) scratch so the recursion never
// mallocs: at depth 1 the bucket arrays alone can reach ~24 MB
// (K2 = 2*(names+2)); fresh std::vector allocation zero-fills them
// twice per block per thread.  Capacities persist across blocks.
struct SaisBuf {
    void *p = nullptr;
    size_t cap = 0;  // bytes
    ~SaisBuf() { free(p); }
    void *ensure(size_t bytes) {
        if (cap < bytes) {
            free(p);
            cap = bytes + bytes / 8;
            p = malloc(cap);
        }
        return p;
    }
};
struct SaisScratch {
    SaisBuf cnt, bkt, lms_pos, red_sa, lms_sorted, redc;
};
static SaisScratch &sais_scratch(int depth) {
    static thread_local std::vector<SaisScratch> tl(24);
    return tl[depth < 24 ? depth : 23];
}

// Core on a combined string with unique smallest sentinel (Tc[n-1]
// raw value 0, type S).  K2 = 2 * (max raw value + 1).  When bwt is
// non-null the final induce also emits bwt[i] = raw(Tc[SA[i]-1]) and
// *prim = the slot holding suffix 0 (top-level BWT fusion; the
// recursion never passes it).
template <typename C>
static void sais_core(const C *Tc, s32 *SA, s32 n, s32 K2,
                      u8 *bwt = nullptr, s32 *prim = nullptr, int depth = 0) {
    SaisScratch &sc = sais_scratch(depth);
    s32 *cnt = (s32 *)sc.cnt.ensure(sizeof(s32) * K2);
    s32 *bkt = (s32 *)sc.bkt.ensure(sizeof(s32) * K2);
    memset(cnt, 0, sizeof(s32) * K2);
    for (s32 i = 0; i < n; i++) cnt[Tc[i]]++;

    // Step 1: place LMS suffixes at combined-bucket ends, induce.
    memset(SA, -1, sizeof(s32) * n);
    {
        s32 sum = 0;
        for (s32 c = 0; c < K2; c++) { sum += cnt[c]; bkt[c] = sum; }
        for (s32 i = n - 1; i >= 1; i--)
            if (is_lms_at(Tc, i)) SA[--bkt[Tc[i]]] = i;
    }
    sais_induce(Tc, SA, n, K2, cnt, bkt);

    // Step 2: name sorted LMS substrings.
    s32 n_lms = 0;
    for (s32 i = 0; i < n; i++)
        if (SA[i] >= 0 && is_lms_at(Tc, SA[i])) SA[n_lms++] = SA[i];
    s32 *names = SA + n_lms;  // upper part of SA reused
    memset(names, -1, sizeof(s32) * (n - n_lms));
    s32 name = 0, prev = -1;
    const s32 NPF = kPrefetch * 2;  // naming-loop prefetch
    for (s32 r = 0; r < n_lms; r++) {
        if (NPF && r + NPF < n_lms) {
            s32 pp = SA[r + NPF];
            __builtin_prefetch(&Tc[pp]);
            __builtin_prefetch(&names[pp / 2], 1);
        }
        s32 pos = SA[r];
        bool diff = false;
        if (prev < 0) diff = true;
        else {
            for (s32 d = 0;; d++) {
                if (Tc[pos + d] != Tc[prev + d]) { diff = true; break; }
                if (d > 0 && (is_lms_at(Tc, pos + d) || is_lms_at(Tc, prev + d))) {
                    diff = !(is_lms_at(Tc, pos + d) && is_lms_at(Tc, prev + d));
                    break;
                }
            }
        }
        if (diff) { name++; prev = pos; }
        names[pos / 2] = name - 1;
    }

    s32 *lms_pos = (s32 *)sc.lms_pos.ensure(sizeof(s32) * (n_lms + 1));
    {
        s32 w = 0;
        for (s32 i = 0; i < n; i++)
            if (is_lms_at(Tc, i)) lms_pos[w++] = i;
    }

    if (name < n_lms) {
        // Step 3: recurse on the reduced string of LMS names.
        // Build the reduced combined string (values name+1, sentinel 0).
        s32 rn = n_lms + 1;
        // Build the reduced combined string directly (values name+1,
        // sentinel 0) — no raw-value intermediate array/pass.
        u32 *redc = (u32 *)sc.redc.ensure(sizeof(u32) * rn);
        {
            u8 t = 1;
            redc[rn - 1] = 1;  // (0<<1)|S
            u32 nxt = 0;
            for (s32 i = rn - 2; i >= 0; i--) {
                u32 v = (u32)(names[lms_pos[i] / 2] + 1);
                t = (v < nxt || (v == nxt && t)) ? 1 : 0;
                redc[i] = (v << 1) | t;
                nxt = v;
            }
        }
        s32 *red_sa = (s32 *)sc.red_sa.ensure(sizeof(s32) * rn);
        sais_core(redc, red_sa, rn, 2 * (name + 2), nullptr, nullptr,
                  depth + 1);
        // red_sa[0] is the reduced sentinel; map the rest back.
        for (s32 i = 1; i < rn; i++) SA[i - 1] = lms_pos[red_sa[i]];
    }
    // else: SA[0..n_lms) already holds LMS positions in sorted order.

    // Step 4: final induced sort from sorted LMS positions.
    s32 *lms_sorted = (s32 *)sc.lms_sorted.ensure(sizeof(s32) * (n_lms + 1));
    memcpy(lms_sorted, SA, sizeof(s32) * n_lms);
    memset(SA, -1, sizeof(s32) * n);
    {
        s32 sum = 0;
        for (s32 c = 0; c < K2; c++) { sum += cnt[c]; bkt[c] = sum; }
        for (s32 r = n_lms - 1; r >= 0; r--) {
            s32 i = lms_sorted[r];
            SA[--bkt[Tc[i]]] = i;
        }
    }
    if (bwt) {
        sais_induce<C, true>(Tc, SA, n, K2, cnt, bkt, bwt, prim);
    } else {
        sais_induce(Tc, SA, n, K2, cnt, bkt);
    }
}

// ------------------------------------------ level-0 raw-u8 SA-IS core
// Specialization of sais_core for the top level, where the text is the
// raw byte string: no combined u16 value|type array is ever built, so
// every random read in the hot loops touches the 1-byte text (half the
// cache footprint) and the setup/compaction passes shrink to scans.
//
// Key ideas (this file's own design; the reference ships libsais'
// 5,428-line amalgam instead, include/libsais.h):
//  - Each SA entry carries its suffix's own type in bit 30, so the
//    induce derives type(j-1) from two adjacent text bytes plus the
//    entry: t(j-1)=L iff T[j-1]>T[j], tie broken by the entry's flag.
//  - The first S-pass marks LMS entries in bit 29 at visit time (an
//    entry is LMS iff it is S-typed and its predecessor induces L) —
//    the LMS compaction then reads no text at all.
//  - LMS boundaries for the naming comparisons come from a 1-bit-per-
//    position vector built in the single setup scan.
// Positions use 29 bits (format caps blocks at 511 MiB; callers guard).
// The augmented string has m = n+1 positions; position n is the unique
// smallest sentinel.  bwt/prim as in sais_core (fused BWT emission).
static const u32 SAIS_POS = (1u << 29) - 1;
static const u32 SAIS_SF = 1u << 30;   // entry's suffix is S-type
static const u32 SAIS_LF = 1u << 29;   // entry is an LMS suffix

static inline bool sais_lbit(const u64 *lms, s32 p) {
    return (lms[p >> 6] >> (p & 63)) & 1;
}

// One L-pass then one S-pass over the raw text.  MARK: set LMS flags
// during the S-pass (step-1 induce).  EMIT: fused BWT emission plus
// primary-index capture (final induce of the BWT path).
template <bool MARK, bool EMIT>
static void sais_induce_u8(const u8 *T, u32 *SAu, s32 n, const s32 *cnt, s32 *bkt,
                           u8 *bwt = nullptr, s32 *prim = nullptr) {
    const s32 m = n + 1;
    const s32 PF = kPrefetch;
    {
        s32 sum = 0;
        for (s32 c = 0; c < 516; c++) { bkt[c] = sum; sum += cnt[c]; }
        for (s32 i = 0; i < m; i++) {
            if (PF && i + PF < m) {
                u32 jp = SAu[i + PF];
                if ((s32)jp >= 0 && (jp & SAIS_POS))
                    __builtin_prefetch(&T[(jp & SAIS_POS) - 1]);
            }
            u32 e = SAu[i];
            if ((s32)e < 0) continue;
            u32 j = e & SAIS_POS;
            if (!j) continue;
            u8 c1 = T[j - 1];
            bool isL;
            if (j == (u32)n) isL = true;  // T[n-1] > sentinel
            else {
                u8 c0 = T[j];
                isL = c1 > c0 || (c1 == c0 && !(e & SAIS_SF));
            }
            if (isL) SAu[bkt[((u32)c1 + 1) << 1]++] = j - 1;
        }
    }
    {
        s32 sum = 0;
        for (s32 c = 0; c < 516; c++) { sum += cnt[c]; bkt[c] = sum; }
        for (s32 i = m - 1; i >= 0; i--) {
            if (PF && i - PF >= 0) {
                u32 jp = SAu[i - PF];
                if ((s32)jp >= 0 && (jp & SAIS_POS))
                    __builtin_prefetch(&T[(jp & SAIS_POS) - 1]);
            }
            u32 e = SAu[i];
            if ((s32)e < 0) continue;
            u32 j = e & SAIS_POS;
            if (!j) {
                if (EMIT) *prim = i;
                continue;
            }
            u8 c1 = T[j - 1];
            if (EMIT) bwt[i] = c1;
            bool isS;
            if (j == (u32)n) isS = false;  // t(n-1) is always L
            else {
                u8 c0 = T[j];
                isS = c1 < c0 || (c1 == c0 && (e & SAIS_SF));
            }
            if (isS) SAu[--bkt[((((u32)c1 + 1) << 1) | 1)]] = (j - 1) | SAIS_SF;
            else if (MARK && (e & SAIS_SF)) SAu[i] = e | SAIS_LF;
        }
    }
}

// Level-0 core.  SA must hold m = n+1 entries; requires n < 2^29.
// With bwt non-null, emits bwt[i] = T[SA[i]-1] fused into the final
// S-pass and sets *prim to the slot of suffix 0.
static void sais_core_u8(const u8 *T, s32 *SA, s32 n,
                         u8 *bwt = nullptr, s32 *prim = nullptr) {
    const s32 m = n + 1;
    u32 *SAu = (u32 *)SA;
    s32 cnt[516], bkt[516];
    memset(cnt, 0, sizeof cnt);

    // Setup: one right-to-left scan computes types on the fly, counts
    // the combined (value<<1|type) buckets, and records LMS positions
    // in a bitvector (thread_local; ~n/8 bytes, reused across blocks).
    static thread_local std::vector<u64> tl_lms;
    {
        tl_lms.assign(((size_t)m + 127) / 64, 0);
        u64 *lms = tl_lms.data();
        cnt[1] = 1;  // sentinel: value 0, S
        lms[n >> 6] |= 1ull << (n & 63);  // t(n)=S, t(n-1)=L: n is LMS
        u8 t = 0;  // type of T[n-1]: L (greater than the sentinel)
        cnt[((u32)(T[n - 1] + 1) << 1)]++;
        for (s32 i = n - 2; i >= 0; i--) {
            u8 c = T[i], d = T[i + 1];
            u8 ti = (c < d || (c == d && t)) ? 1 : 0;
            cnt[(((u32)c + 1) << 1) | ti]++;
            if (!ti && t) lms[(i + 1) >> 6] |= 1ull << ((i + 1) & 63);
            t = ti;
        }

        // Step 1: seed LMS suffixes at S-bucket tails (descending), induce.
        memset(SA, -1, sizeof(s32) * m);
        {
            s32 sum = 0;
            for (s32 c = 0; c < 516; c++) { sum += cnt[c]; bkt[c] = sum; }
            for (s32 w = (m - 1) >> 6; w >= 0; w--) {
                u64 bits = lms[w];
                while (bits) {
                    s32 b = 63 - __builtin_clzll(bits);
                    bits &= ~(1ull << b);
                    s32 i = (w << 6) | b;
                    s32 bi = (i == n) ? 1 : ((((u32)T[i] + 1) << 1) | 1);
                    SAu[--bkt[bi]] = (u32)i | SAIS_SF;
                }
            }
        }
    }
    sais_induce_u8<true, false>(T, SAu, n, cnt, bkt);

    // Step 2: compact the (approximately sorted) LMS entries — flag
    // scan only — then name sorted LMS substrings by raw-byte compare
    // with bitvector boundaries.  Char-equality over the inclusive
    // extent with matching boundaries implies type equality (types
    // back-propagate from the shared LMS tail), so no type compare is
    // needed.
    s32 n_lms = 0;
    const u64 *lms = tl_lms.data();
    for (s32 i = 0; i < m; i++) {
        u32 e = SAu[i];
        if ((s32)e >= 0 && (e & SAIS_LF)) SA[n_lms++] = (s32)(e & SAIS_POS);
    }
    s32 *names = SA + n_lms;
    memset(names, -1, sizeof(s32) * (m - n_lms));
    s32 name = 0, prev = -1;
    const s32 NPF = kPrefetch * 2;
    for (s32 r = 0; r < n_lms; r++) {
        if (NPF && r + NPF < n_lms) {
            s32 pp = SA[r + NPF];
            __builtin_prefetch(&T[pp]);
            __builtin_prefetch(&names[pp / 2], 1);
        }
        s32 pos = SA[r];
        bool diff = false;
        if (prev < 0) diff = true;
        else {
            for (s32 d = 0;; d++) {
                if (pos + d >= n || prev + d >= n) {
                    // one side reached the sentinel position (both
                    // cannot: pos != prev), which matches nothing
                    diff = true;
                    break;
                }
                if (T[pos + d] != T[prev + d]) { diff = true; break; }
                if (d > 0 && (sais_lbit(lms, pos + d) || sais_lbit(lms, prev + d))) {
                    diff = !(sais_lbit(lms, pos + d) && sais_lbit(lms, prev + d));
                    break;
                }
            }
        }
        if (diff) { name++; prev = pos; }
        names[pos / 2] = name - 1;
    }

    // LMS positions in text order: sequential bitvector scan.
    std::vector<s32> lms_pos(n_lms);
    {
        s32 w = 0;
        for (s32 i = 0; i <= (m - 1) >> 6; i++) {
            u64 bits = lms[i];
            while (bits) {
                s32 b = __builtin_ctzll(bits);
                bits &= bits - 1;
                lms_pos[w++] = (i << 6) | b;
            }
        }
    }

    if (name < n_lms) {
        // Step 3: recurse on the reduced string (combined-u32 core).
        s32 rn = n_lms + 1;
        std::vector<u32> redc(rn);
        {
            u8 t2 = 1;
            redc[rn - 1] = 1;
            u32 nxt = 0;
            for (s32 i = rn - 2; i >= 0; i--) {
                u32 v = (u32)(names[lms_pos[i] / 2] + 1);
                t2 = (v < nxt || (v == nxt && t2)) ? 1 : 0;
                redc[i] = (v << 1) | t2;
                nxt = v;
            }
        }
        std::vector<s32> red_sa(rn);
        sais_core(redc.data(), red_sa.data(), rn, 2 * (name + 2), nullptr, nullptr, 1);
        for (s32 i = 1; i < rn; i++) SA[i - 1] = lms_pos[red_sa[i]];
    }

    // Step 4: final induce from the sorted LMS positions.
    std::vector<s32> lms_sorted(SA, SA + n_lms);
    memset(SA, -1, sizeof(s32) * m);
    {
        s32 sum = 0;
        for (s32 c = 0; c < 516; c++) { sum += cnt[c]; bkt[c] = sum; }
        for (s32 r = n_lms - 1; r >= 0; r--) {
            s32 i = lms_sorted[r];
            s32 bi = (i == n) ? 1 : ((((u32)T[i] + 1) << 1) | 1);
            SAu[--bkt[bi]] = (u32)i | SAIS_SF;
        }
    }
    if (bwt) {
        sais_induce_u8<false, true>(T, SAu, n, cnt, bkt, bwt, prim);
    } else {
        sais_induce_u8<false, false>(T, SAu, n, cnt, bkt);
    }
}

// ---------------------------------------------------------------- BWT
// Output contract of libsais_bwt as used by the format (see
// ops/ref/bwt.py): U[0]=T[n-1]; U[1..] = T[SA-1] with the SA[p]==0 row
// dropped; index = p+1.

extern "C" s32 bz3h_bwt_forward(const u8 *in, u8 *out, s32 n, s32 *scratch) {
    if (n <= 1) {
        if (n == 1) out[0] = in[0];
        return n;
    }
    // Raw-u8 level-0 SA-IS with the BWT emitted inside the final
    // induce (no combined array, no post-hoc SA gather).  Caller's
    // scratch is >= 8n bytes (Workspace::ensure); SA takes the first
    // n+1 words, the emission temp the next (n+1)/4+1.
    s32 m = n + 1;
    s32 *SA = scratch;
    u8 *tmp = (u8 *)(scratch + m);
    s32 prim = -1;
    sais_core_u8(in, SA, n, tmp, &prim);
    // tmp[i] = T[SA_ws[i]-1]; tmp[0] is the sentinel row (= T[n-1]);
    // the row with suffix 0 (at slot prim) is dropped; index = prim
    // (libsais_bwt contract, include/libsais.h:4095).
    out[0] = tmp[0];
    memcpy(out + 1, tmp + 1, (size_t)(prim - 1));
    memcpy(out + prim, tmp + prim + 1, (size_t)(m - 1 - prim));
    return prim;
}

extern "C" s32 bz3h_bwt_inverse(const u8 *in, u8 *out, s32 n, s32 index, s32 *scratch,
                                   int64_t scratch_words) {
    if (n <= 1) {
        if (n == 1) out[0] = in[0];
        return index == n ? 0 : -1;
    }
    if (index <= 0 || index > n) return -1;
    // Counting sort of the sentinel-augmented string, then an LF-chain
    // walk.  For blocks < 2^23 the symbol and the LF pointer pack into
    // one u32 node (pointer<<8 | symbol): the walk touches a single
    // array with one cache miss per emitted byte and no branches —
    // the same idea as libsais' packed biPSI entries, reimplemented.
    s32 cnt[257];
    memset(cnt, 0, sizeof cnt);
    cnt[0] = 1;
    for (s32 j = 0; j < n; j++) cnt[in[j] + 1]++;
    s32 start[257];
    s32 sum = 0;
    for (s32 c = 0; c < 257; c++) { start[c] = sum; sum += cnt[c]; }

    // Side allocations for the pair/quad-merge walk; thread_local so
    // every pthread worker amortizes them across blocks (freed at
    // thread exit).  Keeping pair OUT of the caller's scratch matters:
    // at block_size exactly 2^24 (`-b 16`, the headline config) the
    // Workspace scratch is sized for the u64 path, but the post-LZP
    // payload is < 2^24 so this u32 path applies — tying the fast walk
    // to caller scratch silently dropped it to the 1-byte-per-miss
    // fallback (a measured 7 vs 20 MB/s per thread).
    static thread_local std::vector<u64> tl_quad, tl_pair;
    std::vector<u64> *quad_vec = &tl_quad;

    if (n + 1 < (1 << 24) && scratch_words >= (int64_t)(n + 2)) {
        u32 *node = (u32 *)scratch;  // n+1 u32 entries
        for (s32 j = 0; j < index; j++) node[j] = ((u32)start[in[j] + 1]++ << 8) | in[j];
        // The sentinel's symbol is 0xFF, as the oracle's walk emits it
        // (its code 0, minus 1): a sound index never reaches it inside
        // the row, a damaged one (recover mode) can.
        node[index] = ((u32)start[0]++ << 8) | 0xFF;
        for (s32 j = index + 1; j <= n; j++)
            node[j] = ((u32)start[in[j - 1] + 1]++ << 8) | in[j - 1];
        // Pair-merge: pre-compose two LF steps per node so the serial
        // walk takes one dependent cache miss per TWO bytes (the build
        // gathers are independent, so they overlap in the MLP window).
        tl_pair.resize((size_t)n + 2);
        u64 *pair = tl_pair.data();
        for (s32 j = 0; j + 7 <= n; j += 8) {
            // The gather target of iteration j+32 is a sequential read
            // away, so prefetching it extends the MLP window past what
            // the OoO scheduler tracks on its own.
            if (j + 39 <= n)
                for (s32 q = 0; q < 8; q++)
                    __builtin_prefetch(&node[node[j + 32 + q] >> 8]);
            for (s32 q = 0; q < 8; q++) {
                u32 v = node[j + q];
                u32 w = node[v >> 8];
                pair[j + q] = ((u64)(w >> 8) << 16) | ((w & 0xFF) << 8) | (v & 0xFF);
            }
        }
        for (s32 j = n & ~7; j <= n; j++) {
            u32 v = node[j];
            u32 w = node[v >> 8];
            pair[j] = ((u64)(w >> 8) << 16) | ((w & 0xFF) << 8) | (v & 0xFF);
        }
        // Quad-merge (one more composition pass): for big blocks the
        // walk is one dependent miss per FOUR bytes — the libsais
        // interleaved-decoder ILP idea (include/libsais.h:4618-5068)
        // realized by chain squaring instead of aux entry points,
        // which reference streams don't carry.  The quad array is a
        // demand-grown side allocation so small blocks / tight-memory
        // paths never pay for it.
        if (n >= (1 << 18) && quad_vec != nullptr) {
            quad_vec->resize((size_t)n + 2);
            u64 *quad = quad_vec->data();
            for (s32 j = 0; j + 7 <= n; j += 8) {
                if (j + 39 <= n)
                    for (s32 q = 0; q < 8; q++)
                        __builtin_prefetch(&pair[pair[j + 32 + q] >> 16]);
                for (s32 q = 0; q < 8; q++) {
                    u64 v = pair[j + q];
                    u64 w = pair[v >> 16];
                    quad[j + q] = ((w >> 16) << 32) | ((u32)(w & 0xFFFF) << 16) |
                                  (u32)(v & 0xFFFF);
                }
            }
            for (s32 j = n & ~7; j <= n; j++) {
                u64 v = pair[j];
                u64 w = pair[v >> 16];
                quad[j] = ((w >> 16) << 32) | ((u32)(w & 0xFFFF) << 16) |
                          (u32)(v & 0xFFFF);
            }
            s32 k = n - 1;
            u64 q = quad[0];
            while (k >= 3) {
                out[k] = (u8)q;
                out[k - 1] = (u8)(q >> 8);
                out[k - 2] = (u8)(q >> 16);
                out[k - 3] = (u8)(q >> 24);
                k -= 4;
                q = quad[q >> 32];
            }
            while (k >= 0) {
                out[k] = (u8)q;
                q >>= 8;
                k--;
            }
        } else {
            s32 k = n - 1;
            u64 i = pair[0];
            while (k >= 1) {
                out[k] = (u8)i;
                out[k - 1] = (u8)(i >> 8);
                k -= 2;
                i = pair[i >> 16];
            }
            if (k == 0) out[0] = (u8)i;
        }
    } else if (n + 1 < (1 << 24)) {
        u32 *node = (u32 *)scratch;
        for (s32 j = 0; j < index; j++) node[j] = ((u32)start[in[j] + 1]++ << 8) | in[j];
        node[index] = ((u32)start[0]++ << 8) | 0xFF;
        for (s32 j = index + 1; j <= n; j++)
            node[j] = ((u32)start[in[j - 1] + 1]++ << 8) | in[j - 1];
        u32 i = node[0];
        for (s32 k = n - 1; k >= 0; k--) {
            out[k] = (u8)i;
            i = node[i >> 8];
        }
    } else {
        u64 *node = (u64 *)scratch;  // n+1 u64 entries (scratch is 2x)
        for (s32 j = 0; j < index; j++) node[j] = ((u64)start[in[j] + 1]++ << 8) | in[j];
        node[index] = ((u64)start[0]++ << 8) | 0xFF;
        for (s32 j = index + 1; j <= n; j++)
            node[j] = ((u64)start[in[j - 1] + 1]++ << 8) | in[j - 1];
        // The headline `-b 16` block is EXACTLY 2^24 bytes — one past
        // the u32 packed-node limit — so the big-block path gets the
        // same pair+quad chain squaring, with 48-bit pointers in the
        // u64 entries (ptr<<16 | 2 syms; composing once more keeps
        // ptr<<32 | 4 syms in range for any valid block size).
        static thread_local std::vector<u64> tl_pair64;
        // extra memory is 16 B/input byte; cap the side allocations at
        // 64 MiB blocks (1 GiB extra) — beyond that the plain walk.
        if (quad_vec != nullptr && n <= (1 << 26)) {
            tl_pair64.resize((size_t)n + 2);
            u64 *pair = tl_pair64.data();
            for (s32 j = 0; j <= n; j++) {
                u64 v = node[j];
                u64 w = node[v >> 8];
                pair[j] = ((w >> 8) << 16) | ((w & 0xFF) << 8) | (v & 0xFF);
            }
            quad_vec->resize((size_t)n + 2);
            u64 *quad = quad_vec->data();
            for (s32 j = 0; j <= n; j++) {
                u64 v = pair[j];
                u64 w = pair[v >> 16];
                quad[j] = ((w >> 16) << 32) | ((u32)(w & 0xFFFF) << 16) |
                          (u32)(v & 0xFFFF);
            }
            s32 k = n - 1;
            u64 q = quad[0];
            while (k >= 3) {
                out[k] = (u8)q;
                out[k - 1] = (u8)(q >> 8);
                out[k - 2] = (u8)(q >> 16);
                out[k - 3] = (u8)(q >> 24);
                k -= 4;
                q = quad[q >> 32];
            }
            while (k >= 0) {
                out[k] = (u8)q;
                q >>= 8;
                k--;
            }
        } else {
            u64 i = node[0];
            for (s32 k = n - 1; k >= 0; k--) {
                out[k] = (u8)i;
                i = node[i >> 8];
            }
        }
    }
    return 0;
}
