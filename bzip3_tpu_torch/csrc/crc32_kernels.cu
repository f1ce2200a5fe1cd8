// CRC-32C lane scan for Hopper (sm_90a): K4.
//
// Replaces the TPU's Pallas kernel in bzip3_tpu/ops/device/crc32_pallas.py:
//   K4 crc_lane_kernel <- _make_crc_kernel (:45), launched by
//      crc_lane_scan_pallas (:76), public crc32_batch_pallas (:112).
// Semantics: the plain version crc_lane_scan in ops/device/crc32.py,
// which the chip smoke test holds this kernel against bit for bit; the
// GF(2) lane combine and the pad unwind that follow stay tensor code.
//
// What bounds it: every byte of the batch is read once, so the bound is
// bytes over 3.35 TB/s (0.040 ms for 8 x 16 MiB).  Each lane is one
// dependent chain of table steps (a shared-memory load, two xors and a
// shift per byte), so the lanes must be many enough to hide that chain:
// the TPU kernel's 2048 lanes per row are a VMEM tiling constant, while
// here the wrapper picks 32768 lanes, which at 8 rows puts ~2,000
// threads on each of the 132 SMs.
//
// Design: one thread per lane, 256 threads per CTA, grid (lanes/256,
// rows).  The CTA builds the 256-entry table in shared memory, then
// each thread walks its lane's contiguous segment with init 0, byte by
// byte through the read-only cache (neighbouring bytes of one lane share
// a cache line, so each line is fetched once), and writes one state.
// Bytes at or past the row's length are zero steps, as are the bytes
// past the row's width in the zero-padded lanes * seg layout.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPoly = 0x82F63B78u;  // reflected Castagnoli

__global__ void __launch_bounds__(kThreads)
crc_lane_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int64_t in_width,
                const int32_t *__restrict__ lens, int32_t lanes, int64_t seg,
                uint32_t *__restrict__ out) {
    __shared__ uint32_t table[256];
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ kPoly : c >> 1;
        table[i] = c;
    }
    __syncthreads();
    const int64_t row = blockIdx.y;
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    int64_t n = lens[row];
    n = n < 0 ? 0 : (n > in_width ? in_width : n);
    const uint8_t *src = in + row * in_stride;
    int64_t pos = lane * seg;
    const int64_t end = pos + seg;
    const int64_t stop = end < n ? end : n;
    uint32_t crc = 0;
    for (; pos < stop; ++pos) crc = table[(crc ^ __ldg(src + pos)) & 0xFFu] ^ (crc >> 8);
    for (; pos < end; ++pos) crc = table[crc & 0xFFu] ^ (crc >> 8);
    out[row * lanes + lane] = crc;
}

}  // namespace

// Launcher with a plain C interface; returns the launch's cudaError_t.
// out is [rows, lanes]: the state of lane l of row r at out[r*lanes+l].
extern "C" int bz3t_crc_lanes(const uint8_t *in, int64_t in_stride, int64_t in_width,
                              const int32_t *lens, int32_t lanes, int64_t seg, uint32_t *out,
                              int32_t rows, void *stream) {
    const dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads), (unsigned)rows);
    crc_lane_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, in_stride, in_width,
                                                                  lens, lanes, seg, out);
    return (int)cudaGetLastError();
}
