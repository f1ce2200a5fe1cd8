// CRC-32C lane scan for Hopper (sm_90a): K4.
//
// Replaces the TPU's Pallas kernel in bzip3_tpu/ops/device/crc32_pallas.py:
//   K4 crc_lane_kernel <- _make_crc_kernel (:45), launched by
//      crc_lane_scan_pallas (:76), public crc32_batch_pallas (:112).
// Semantics: the plain version crc_lane_scan in ops/device/crc32.py at
// the caller's lane count L (seg = ceil(N / L) bytes a lane): lane l of
// row r is the CRC state, init 0, of bytes [l*seg, (l+1)*seg) of the
// row, every byte at or past the row's length (or its width) a zero
// step.  The chip smoke test holds this kernel against it bit for bit;
// the GF(2) combine of the L lanes and the pad unwind stay tensor code.
//
// What bounds it: every byte of the batch is read once, so the bound is
// bytes over 3.35 TB/s (0.040 ms for 8 x 16 MiB).  One thread a lane
// reading a byte a load, with a warp's 32 lanes 512 bytes apart, would
// touch 32 cache lines a warp load and be bound by L1 wavefronts.  This
// design:
//
// - One CTA of 512 threads a lane, so the wrapper picks L near the
//   SM count (crc32.kernel_lanes): one wave of CTAs, one per SM.
// - The lane's bytes go to the threads in 16-byte units, round robin:
//   round i of thread t reads unit i*512 + t, so a warp's loads are 512
//   contiguous bytes (ld.global.nc.v4, four rounds in flight).  A
//   thread's units lie 8 KiB apart, so its state s follows
//       s = shift_8KiB(s) ^ crc0(unit)
//   (crc(A||B) = shift_|B|(crc(A)) ^ crc(B) with init 0): crc0 of a
//   unit by slice-by-4 (16 lookups), the shift by 4 lookups in
//   byte-indexed tables of that fixed shift.
// - The four slice tables (4 x 256 words) are kept once per bank (128
//   KB): lane c reads copy c, and a warp's gather is one shared-memory
//   wavefront whatever the bytes.  The shift tables (4 KB) are shared;
//   they are read 4 times a unit against 16 for the slice tables.  A
//   unit then costs ~75 instructions, 2 an index (shift, mask-or).
// - Rounds are aligned to the end of the lane's 16-byte units, so after
//   the last round thread t's state ends 16*(511-t) bytes before them;
//   the CTA folds its 512 states into one in 9 butterfly levels
//   (shuffles within a warp, shared memory across warps), level j
//   shifting the lower half by 2^(4+j) bytes: a 32x32 GF(2) matrix,
//   Z^(2^k) for a shift of 2^k bytes, from the wrapper's [32, 32]
//   bank.  Units before the lane's first unit are zero and not read.
// - The lane's first unit is masked below the lane's start; the bytes
//   past its last whole unit, up to the row's length (< 16), are table
//   steps of one thread; the zero steps after the length are one shift
//   of the folded state by their count.  A lane wholly past the length
//   writes 0 at once.
// Its times on the card, beside the bound and the card's name and power
// limit, are in PERF.md section 6 (scripts/torch_crc_ab.py, chip_smoke.py).
// Rows start 16-byte aligned at a stride that is a multiple of 16
// (the wrapper pads them otherwise); nothing at or past a row's length
// is read: a lane with no whole unit loads none.

#include <cstdint>
#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char smem[];  // K4's tables

namespace {

// Threads of a CTA and rounds whose loads are in flight together.  The
// emulated test (tests/test_torch_crc32_emulated.py) also builds this
// source with fewer of both, so that KiB rows take several groups.
#ifndef BZ3T_CRC_THREADS
#define BZ3T_CRC_THREADS 512
#define BZ3T_CRC_GROUP 4
#endif
constexpr int kThreads = BZ3T_CRC_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = BZ3T_CRC_GROUP;
constexpr uint32_t kPoly = 0x82F63B78u;  // reflected Castagnoli
constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }
// A round is kThreads units of 16 bytes: 2^13 bytes at 512 threads.
constexpr int kRoundLog2 = log2i(16 * kThreads);
static_assert(16 * kThreads == 1 << kRoundLog2 && kWarps <= 32, "round size");
// Shared memory, in words: the slice-by-4 tables, one copy per bank
// (table k, entry e, copy c at (k << 13) | (e << 5) | c); the round
// shift's four byte-indexed tables; the [32, 32] bank of Z^(2^k); the
// warps' folded states.
constexpr int kSliceWords = 4 * 256 * 32;
constexpr int kShiftWords = 4 * 256;
constexpr int kPowWords = 32 * 32;
constexpr int kSmemBytes = 4 * (kSliceWords + kShiftWords + kPowWords + kWarps);
constexpr uint32_t kShiftAt = 4 * kSliceWords;  // byte offset of the shift tables

// The shared word at byte offset `at` (a constant plus a register, so
// that the load takes the constant as its immediate).
__device__ __forceinline__ uint32_t lds(uint32_t at) {
    return *reinterpret_cast<const uint32_t *>(smem + at);
}

// A 32x32 GF(2) matrix (32 column words) applied to v.
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t *col, uint32_t v) {
    uint32_t r = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) r ^= col[b] & (0u - ((v >> b) & 1u));
    return r;
}

// One slice-by-4 step from state 0 over the little-endian word v:
// T3[b0] ^ T2[b1] ^ T1[b2] ^ T0[b3], Tk the table of a byte followed by
// k zero bytes, each from the lane's copy (lane4 = 4 * lane): a shift
// and a mask-or an index.
__device__ __forceinline__ uint32_t slice4(uint32_t lane4, uint32_t v) {
    return lds((3 << 15) + (((v << 7) & 0x7F80u) | lane4)) ^
           lds((2 << 15) + (((v >> 1) & 0x7F80u) | lane4)) ^
           lds((1 << 15) + (((v >> 9) & 0x7F80u) | lane4)) ^ lds(((v >> 17) & 0x7F80u) | lane4);
}

// The state s advanced past one round (2^13 bytes at 512 threads) of zeros.
__device__ __forceinline__ uint32_t round_shift(uint32_t s) {
    return lds(kShiftAt + ((s << 2) & 0x3FCu)) ^ lds(kShiftAt + 1024 + ((s >> 6) & 0x3FCu)) ^
           lds(kShiftAt + 2048 + ((s >> 14) & 0x3FCu)) ^ lds(kShiftAt + 3072 + ((s >> 22) & 0x3FCu));
}

// The unit x with its bytes below `lo` zeroed.
__device__ __forceinline__ uint4 mask_below(uint4 x, int lo) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    uint32_t m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int cut = lo - 4 * k;  // bytes of word k to clear
        m[k] = cut <= 0 ? w[k] : cut >= 4 ? 0u : w[k] & (0xFFFFFFFFu << (8 * cut));
    }
    return make_uint4(m[0], m[1], m[2], m[3]);
}

// The CRC state, init 0, of one 16-byte unit (0 for a zero unit).
__device__ __forceinline__ uint32_t unit_crc(uint32_t lane4, uint4 x) {
    uint32_t c = slice4(lane4, x.x);
    c = slice4(lane4, c ^ x.y);
    c = slice4(lane4, c ^ x.z);
    return slice4(lane4, c ^ x.w);
}

__global__ void __launch_bounds__(kThreads)
crc_lane_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                const int32_t *__restrict__ lens, int32_t lanes, int64_t seg,
                const uint32_t *__restrict__ pow2, uint32_t *__restrict__ out) {
    uint32_t *slice = reinterpret_cast<uint32_t *>(smem);
    uint32_t *shift = slice + kSliceWords;
    uint32_t *pw = shift + kShiftWords;
    uint32_t *warp_state = pw + kPowWords;

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int64_t row = blockIdx.y, l = blockIdx.x;
    int64_t n = lens[row];
    n = n < 0 ? 0 : (n > in_width ? in_width : n);
    const int64_t a = l * seg, e = a + seg;  // the lane's bytes
    const int64_t d_end = e < n ? e : n;     // its data end; zero steps after
    uint32_t *dst = out + row * lanes + l;
    if (d_end <= a) {  // only zero steps from init 0
        if (t == 0) *dst = 0;
        return;
    }
    const uint8_t *src = in + row * in_stride;
    const int64_t a16 = a & ~(int64_t)15, d16 = d_end & ~(int64_t)15;
    // units < 2^27: a lane is at most a row of int32 length
    const int32_t units = d16 > a16 ? (int32_t)((d16 - a16) >> 4) : 0;
    constexpr int32_t kSpan = kThreads * kGroup;  // units of a group
    const int32_t groups = (units + kSpan - 1) / kSpan;
    // Thread t's unit in virtual round i is u0 + i * kThreads: the last
    // round holds units [units - kThreads, units).  Units < 0 (only in
    // group 0) are zero and not read: their steps leave s at 0.  Unit 0
    // is in group 0 too; its bytes below the lane are zeroed there.  With
    // no units (groups 0) u0 = t, and nothing may be loaded.
    const int32_t u0 = units - groups * kSpan + t;
    const uint4 *base = reinterpret_cast<const uint4 *>(src + a16);
    const int lo = (int)(a - a16);  // bytes of unit 0 below the lane

    uint4 cur[kGroup], nxt[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
        const int32_t u = u0 + r * kThreads;
        cur[r] = u >= 0 && u < units ? __ldg(base + u) : make_uint4(0u, 0u, 0u, 0u);
        if (u == 0 && lo > 0) cur[r] = mask_below(cur[r], lo);
    }

    // Tables, while the first loads are in flight.
    for (int idx = t; idx < 1024; idx += kThreads) {
        const int k = idx >> 8, b = idx & 255;
        uint32_t c = (uint32_t)b;  // byte b, then k zero bytes
        for (int s = 0; s < 8 * (k + 1); ++s) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
        uint32_t *row_k = slice + (k << 13) + (b << 5);
        for (int i = 0; i < 32; ++i) row_k[(lane + i) & 31] = c;  // bank (lane+i)&31
        // the round shift of byte b at byte position k of the state
        const uint32_t *col = pow2 + kRoundLog2 * 32 + 8 * k;
        uint32_t v = 0;
        for (int bit = 0; bit < 8; ++bit) v ^= __ldg(col + bit) & (0u - ((uint32_t)(b >> bit) & 1u));
        shift[idx] = v;
    }
    for (int idx = t; idx < kPowWords; idx += kThreads) pw[idx] = __ldg(pow2 + idx);
    __syncthreads();

    const uint32_t lane4 = 4 * lane;
    uint32_t s = 0;
    for (int32_t g = 0; g < groups; ++g) {
        if (g + 1 < groups) {  // units of group g + 1 >= 1: all real
            const uint4 *p = base + (u0 + (g + 1) * kSpan);
#pragma unroll
            for (int r = 0; r < kGroup; ++r) nxt[r] = __ldg(p + r * kThreads);
        }
#pragma unroll
        for (int r = 0; r < kGroup; ++r) s = round_shift(s) ^ unit_crc(lane4, cur[r]);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) cur[r] = nxt[r];
    }

    // Fold: thread t's state ends 16 * (kThreads - 1 - t) bytes before
    // d16 (a16 if there are no units).  Level j joins groups of 2^j
    // threads: lower half shifted by 2^(4+j) bytes, xor the upper half.
    for (int j = 0; j < 5; ++j) {
        const uint32_t o = __shfl_sync(0xFFFFFFFFu, s, lane ^ (1 << j));
        const bool upper = (lane >> j) & 1;
        s = gf2_apply(pw + (4 + j) * 32, upper ? o : s) ^ (upper ? s : o);
    }
    if (lane == 0) warp_state[warp] = s;
    __syncthreads();
    if (warp != 0) return;
    s = lane < kWarps ? warp_state[lane] : 0u;
    for (int j = 0; (1 << j) < kWarps; ++j) {
        const uint32_t o = __shfl_sync(0xFFFFFFFFu, s, lane ^ (1 << j));
        const bool upper = (lane >> j) & 1;
        s = gf2_apply(pw + (9 + j) * 32, upper ? o : s) ^ (upper ? s : o);
    }
    if (lane != 0) return;
    // s is the state of bytes [a, max(a, d16)); then the tail bytes up
    // to d_end, and the zero steps from d_end to e.
    for (int64_t p = a > d16 ? a : d16; p < d_end; ++p)
        s = slice[(uint32_t)((s ^ __ldg(src + p)) & 0xFFu) << 5] ^ (s >> 8);
    uint64_t z = (uint64_t)(e - d_end);
    for (int k = 0; z; ++k, z >>= 1)
        if (z & 1) s = gf2_apply(pw + k * 32, s);
    *dst = s;
}

}  // namespace

// Launcher with a plain C interface; returns the launch's cudaError_t.
// out is [rows, lanes]: the state of lane l of row r at out[r*lanes+l].
// pow2 is the [32, 32] bank of Z^(2^k) (k = 0..31) on the card.
extern "C" int bz3t_crc_lanes(const uint8_t *in, int64_t in_stride, int64_t in_width,
                              const int32_t *lens, int32_t lanes, int64_t seg,
                              const uint32_t *pow2, uint32_t *out, int32_t rows, void *stream) {
    cudaError_t err = cudaFuncSetAttribute(crc_lane_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    crc_lane_kernel<<<dim3((unsigned)lanes, (unsigned)rows), kThreads, kSmemBytes,
                      (cudaStream_t)stream>>>(in, in_stride, in_width, lens, lanes, seg, pow2,
                                              out);
    return (int)cudaGetLastError();
}

// Dynamic shared memory of one K4 CTA, in bytes.
extern "C" int32_t bz3t_crc_smem_bytes() { return kSmemBytes; }
