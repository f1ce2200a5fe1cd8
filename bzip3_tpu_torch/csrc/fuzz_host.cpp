// ASan/UBSan fuzzer for the port's host C++ (host_codec.cpp,
// host_stages.cpp, host_bwt.cpp): the counterpart of the repository's
// csrc/fuzz_bz3n.cpp for the native runtime, after the reference's
// adversarial contract (examples/fuzz-decode-block.c: feed
// attacker-controlled [orig_size, payload] into the block decoder, built
// with ASan/UBSan).  The host code decodes the same untrusted blocks as
// the card in the port's native and hybrid engines and in recover mode.
// Not part of the host library: build it on its own, with the three
// sources as separate translation units,
//
//   g++ -O1 -g -fsanitize=address,undefined -fno-sanitize-recover=all \
//       -pthread fuzz_host.cpp host_stages.cpp host_bwt.cpp host_codec.cpp \
//       -o fuzz_host && ./fuzz_host 20000
//
// (`make fuzz-host-torch`).  Every buffer the code reads or writes is a
// heap allocation of exactly the size its contract names, so that a
// sanitizer sees one byte past it.  Per iteration:
//   1. one block of one of five data shapes, encoded, and three attack
//      classes on bz3h_decode_block: random byte corruptions, pure
//      garbage, truncation, with an adversarial orig_size a quarter of
//      the time;
//   2. every 8th iteration, the threaded bz3h_decode_blocks on a batch
//      of 1-8 of the last damaged and intact blocks on 4 workers, each
//      result equal to bz3h_decode_block's on the same block;
//   3. bz3h_bwt_inverse of the block's BWT at every index class (0, 1,
//      the primary index, n - 1, n, n + 1, -1, INT32_MIN, INT32_MAX, and
//      rows of 0-2 bytes), the primary index giving the data back;
//   4. bz3h_lzp_decode and bz3h_rle_decode of the block's own streams,
//      damaged ones and garbage at max_out edges (4, the decoded length,
//      one less, one more, and the buffer bound);
//   5. a round-trip assert on the intact block.
//
//   usage: fuzz_host [iterations] [seed] [block_size]

#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

typedef uint8_t u8;
typedef int32_t s32;
typedef uint32_t u32;

extern "C" {
u32 bz3h_crc32(const u8 *buf, s32 n);
s32 bz3h_rle_encode(const u8 *in, s32 n, u8 *out, s32 out_cap);
s32 bz3h_rle_decode(const u8 *in, s32 n, u8 *out, s32 out_len);
s32 bz3h_lzp_encode(const u8 *in, s32 n, u8 *out, s32 *lut);
s32 bz3h_lzp_decode(const u8 *in, s32 n, u8 *out, s32 max_out, s32 *lut);
s32 bz3h_bwt_forward(const u8 *in, u8 *out, s32 n, s32 *scratch);
s32 bz3h_bwt_inverse(const u8 *in, u8 *out, s32 n, s32 index, s32 *scratch,
                     int64_t scratch_words);
s32 bz3h_encode_block(const u8 *in, s32 n, u8 *out);
s32 bz3h_decode_block(const u8 *in, s32 in_len, s32 orig_size, s32 block_size, u8 *out);
void bz3h_decode_blocks(const u8 **ins, const s32 *in_lens, const s32 *orig_sizes,
                        s32 block_size, u8 **outs, s32 *results, s32 n, s32 n_threads);
}

static uint64_t rng_state = 0x9E3779B97F4A7C15ull;
static uint64_t rnd() {
    rng_state ^= rng_state << 13;
    rng_state ^= rng_state >> 7;
    rng_state ^= rng_state << 17;
    return rng_state;
}

static s32 bound(s32 n) { return n + n / 50 + 32; }

static long fails = 0;
static void fail(const char *what, long it, long a, long b) {
    fprintf(stderr, "fuzz_host: %s at iteration %ld (%ld, %ld)\n", what, it, a, b);
    fails++;
}

// A heap copy of exactly n bytes (at least 1, so data() is a real
// allocation the sanitizer bounds).
static std::vector<u8> exact(const u8 *p, s32 n) {
    std::vector<u8> v((size_t)(n > 0 ? n : 1));
    if (n > 0) memcpy(v.data(), p, (size_t)n);
    v.resize((size_t)(n > 0 ? n : 0));
    v.shrink_to_fit();
    return v;
}

static s32 decode_one(const std::vector<u8> &blk, s32 osize, s32 bs, std::vector<u8> &out) {
    out.assign((size_t)bound(bs) + 64, 0);
    std::vector<u8> in = exact(blk.data(), (s32)blk.size());
    return bz3h_decode_block(in.data(), (s32)in.size(), osize, bs, out.data());
}

static void bwt_indices(long it, const u8 *data, s32 n) {
    std::vector<u8> in = exact(data, n), u((size_t)n + 1), back((size_t)n + 1);
    std::vector<s32> scratch(2 * ((size_t)n + 16) + 16);
    const s32 prim = bz3h_bwt_forward(in.data(), u.data(), n, scratch.data());
    if (prim < 0) { fail("bwt_forward", it, n, prim); return; }
    std::vector<u8> ue = exact(u.data(), n);
    const int64_t words = 2 * ((int64_t)n + 16);
    const s32 idxs[] = {0, 1, prim, n - 1, n, n + 1, -1, INT_MIN, INT_MAX};
    for (s32 idx : idxs) {
        std::vector<u8> out((size_t)(n > 0 ? n : 1));
        std::vector<s32> sc((size_t)words + 16);
        const s32 r = bz3h_bwt_inverse(ue.data(), out.data(), n, idx, sc.data(), words);
        if (idx == prim && (r != 0 || (n > 0 && memcmp(out.data(), data, (size_t)n) != 0)))
            fail("bwt_inverse of the primary index", it, n, idx);
        if ((n > 1 && (idx <= 0 || idx > n)) && r == 0) fail("bwt_inverse took a bad index", it, n, idx);
    }
}

static void lzp_rle_edges(long it, const u8 *data, s32 n, s32 bs) {
    std::vector<s32> lut((size_t)1 << 18);
    std::vector<u8> src = exact(data, n);
    // the block's own LZP and RLE streams, one damaged copy of each, garbage
    std::vector<std::vector<u8>> lzp, rle;
    std::vector<u8> tmp((size_t)2 * n + 64);
    const s32 l = bz3h_lzp_encode(src.data(), n, tmp.data(), lut.data());
    if (l > 0) lzp.push_back(exact(tmp.data(), l));
    const s32 r = bz3h_rle_encode(src.data(), n, tmp.data(), (s32)tmp.size());
    if (r > 0) rle.push_back(exact(tmp.data(), r));
    for (size_t k = 0, m = lzp.size(); k < m; k++) {
        std::vector<u8> d = lzp[k];
        d[rnd() % d.size()] ^= (u8)(1 + rnd() % 255);
        lzp.push_back(d);
        lzp.push_back(exact(d.data(), (s32)(rnd() % d.size())));
    }
    for (size_t k = 0, m = rle.size(); k < m; k++) {
        std::vector<u8> d = rle[k];
        if (d.size() > 32) d[32 + rnd() % (d.size() - 32)] ^= (u8)(1 + rnd() % 255);
        rle.push_back(d);
        rle.push_back(exact(d.data(), (s32)(rnd() % d.size())));
    }
    const s32 gl = (s32)(rnd() % 300);
    std::vector<u8> g((size_t)gl);
    for (s32 i = 0; i < gl; i++) g[i] = (rnd() % 3) ? 0xF2 : (u8)rnd();
    lzp.push_back(g);
    rle.push_back(g);

    const s32 cap = bound(bs);
    for (const std::vector<u8> &s : lzp) {
        // the decoded length under the bound, then max_out edges around it
        std::vector<u8> big((size_t)cap + 64);
        const s32 full = bz3h_lzp_decode(s.data(), (s32)s.size(), big.data(), cap, lut.data());
        const s32 edges[] = {4, full - 1, full, full + 1, cap};
        for (s32 mo : edges) {
            if (mo < 4) continue;  // the decoder writes its 4 context bytes first
            std::vector<u8> out((size_t)mo);
            const s32 got = bz3h_lzp_decode(s.data(), (s32)s.size(), out.data(), mo, lut.data());
            if (got > mo) fail("lzp_decode past max_out", it, got, mo);
            if (full >= 0 && mo >= full && (got != full || memcmp(out.data(), big.data(), (size_t)full)))
                fail("lzp_decode differs under a larger max_out", it, got, full);
        }
    }
    for (const std::vector<u8> &s : rle) {
        const s32 edges[] = {0, 1, n - 1, n, n + 1, cap};
        for (s32 ol : edges) {
            if (ol < 0) continue;
            std::vector<u8> out((size_t)(ol > 0 ? ol : 1));
            const s32 got = bz3h_rle_decode(s.data(), (s32)s.size(), out.data(), ol);
            if (got >= 0 && got != ol) fail("rle_decode length", it, got, ol);
            if (&s == &rle[0] && r > 0 && ol == n && (got != n || memcmp(out.data(), data, (size_t)n)))
                fail("rle_decode of the block's own stream", it, got, n);
        }
    }
}

int main(int argc, char **argv) {
    const long iters = argc > 1 ? atol(argv[1]) : 10000;
    if (argc > 2) rng_state = strtoull(argv[2], nullptr, 0);
    const s32 block_size = argc > 3 ? (s32)atol(argv[3]) : 65 * 1024;
    const s32 cap = bound(block_size) + 64;
    std::vector<u8> data(cap), enc(cap), dec;
    std::vector<std::vector<u8>> recent;
    std::vector<s32> recent_osize;

    long rejects = 0, accepts = 0, batches = 0;
    for (long it = 0; it < iters; it++) {
        // small blocks most of the time keep the volume high; one in 16
        // runs up to the block size
        const s32 top = (rnd() % 16 == 0) ? block_size : (block_size < 4096 ? block_size : 4096);
        const s32 n = (s32)(rnd() % (u32)top) + 1;
        const int mode = (int)(rnd() % 5);
        for (s32 i = 0; i < n; i++) {
            switch (mode) {
                case 0: data[i] = 'a' + (u8)(rnd() % 26); break;
                case 1: data[i] = (u8)((i >> (rnd() % 8)) & 0xFF); break;
                case 2: data[i] = (u8)rnd(); break;
                case 3: data[i] = (rnd() % 100 == 0) ? (u8)rnd() : 0; break;
                default: data[i] = (u8)(i & 1 ? 0xf2 : 0x00); break;
            }
        }
        std::vector<u8> in = exact(data.data(), n);
        std::vector<u8> out((size_t)bound(n) + 64);
        const s32 elen = bz3h_encode_block(in.data(), n, out.data());
        if (elen <= 0) { fail("encode", it, n, elen); continue; }
        std::vector<u8> valid = exact(out.data(), elen);

        // 5. the intact block round-trips
        s32 r = decode_one(valid, n, block_size, dec);
        if (r != n || memcmp(dec.data(), data.data(), (size_t)n) != 0) fail("round trip", it, n, r);

        // 1. three attack classes
        std::vector<u8> fz;
        const int attack = (int)(rnd() % 3);
        if (attack == 0) {
            fz = valid;
            const int flips = 1 + (int)(rnd() % 8);
            for (int f = 0; f < flips; f++) fz[rnd() % fz.size()] ^= (u8)(1 + rnd() % 255);
        } else if (attack == 1) {
            fz.resize((size_t)(rnd() % 256) + 1);
            for (u8 &b : fz) b = (u8)rnd();
        } else {
            fz = exact(valid.data(), (s32)(rnd() % valid.size()) + 1);
        }
        const s32 osize = (rnd() % 4 == 0) ? (s32)(rnd() % ((u32)cap + 2)) : n;
        r = decode_one(fz, osize, block_size, dec);
        if (r < 0) rejects++; else accepts++;
        recent.push_back(rnd() % 3 ? fz : valid);
        recent_osize.push_back(recent.back() == valid ? n : osize);
        if (recent.size() > 8) {
            recent.erase(recent.begin());
            recent_osize.erase(recent_osize.begin());
        }

        // 2. the threaded pool on a mixed batch
        if (it % 8 == 7) {
            const s32 k = 1 + (s32)(rnd() % recent.size());
            std::vector<std::vector<u8>> ins(k), outs(k);
            std::vector<const u8 *> inp(k);
            std::vector<u8 *> outp(k);
            std::vector<s32> lens(k), os(k), res(k);
            for (s32 j = 0; j < k; j++) {
                ins[j] = exact(recent[j].data(), (s32)recent[j].size());
                outs[j].assign((size_t)bound(block_size) + 64, 0);
                inp[j] = ins[j].data();
                outp[j] = outs[j].data();
                lens[j] = (s32)ins[j].size();
                os[j] = recent_osize[j];
            }
            bz3h_decode_blocks(inp.data(), lens.data(), os.data(), block_size, outp.data(),
                               res.data(), k, 4);
            for (s32 j = 0; j < k; j++) {
                const s32 one = decode_one(recent[j], os[j], block_size, dec);
                if (one != res[j] || (one > 0 && memcmp(dec.data(), outs[j].data(), (size_t)one)))
                    fail("pool result differs from one block's", it, res[j], one);
            }
            batches++;
        }

        // 3. the inverse BWT at every index class, and rows of 0-2 bytes
        bwt_indices(it, data.data(), n > 2048 ? 2048 : n);
        if (it % 64 == 0)
            for (s32 m = 0; m <= 2; m++) bwt_indices(it, data.data(), m);

        // 4. LZP and RLE decoders at max_out edges
        lzp_rle_edges(it, data.data(), n > 2048 ? 2048 : n, block_size);
    }
    printf("fuzz_host: %ld iterations, %ld rejected and %ld accepted damaged blocks, "
           "%ld pool batches, %ld failures\n", iters, rejects, accepts, batches, fails);
    return fails ? 1 : 0;
}
