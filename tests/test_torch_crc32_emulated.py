"""The CUDA source of K4 (``bzip3_tpu_torch/csrc/crc32_kernels.cu``: the
CRC-32C lane scan, one CTA a lane, 16-byte units round robin over its
threads, the threads' states folded in the CTA) run on the CPU under a
host emulation of the CUDA built-ins (``tests/cuda_emu.h``: one thread
per CUDA thread, the warp shuffles as exchanges between counting
barriers).  Its lane states are held bit for bit (tolerance 0) against
the plain PyTorch version ``crc32.crc_lane_scan`` at the same lane
count, and the CRCs folded from them against the JAX package's oracle
``bzip3_tpu/ops/ref/crc32.py``.

The source is built twice: as the card runs it (512 threads, loads of
4 rounds in flight), and with 64 threads and 2 rounds, so that rows of
a few KiB take several rounds and groups.  Rows hold random bytes past
their lengths, which must not count.  The emulation says nothing of
speed; the chip smoke test holds the kernel itself against the plain
version.
"""

import ctypes
import os
import shlex
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bzip3_tpu.ops.ref.crc32 import crc32 as ref_crc32
from bzip3_tpu_torch.ops.device import crc32, gf2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# extra compiler flags for the emulation (scripts/torch_sanitize.py --emulated
# builds it under ASan/UBSan)
EMU_FLAGS = shlex.split(os.environ.get("BZ3_EMU_CXXFLAGS", ""))
SRC = os.path.join(ROOT, "bzip3_tpu_torch", "csrc", "crc32_kernels.cu")

# (pattern, replacement, times it must match) turning the CUDA source into C++
_EDITS = [
    (r"#include <cuda_runtime.h>", "", 1),
    (r"<<<[^>]*>>>", "", 1),
    (r"extern __shared__ __align__\(16\) unsigned char smem\[\];", "", 1),
]

# The kernel may read through __ldg only each row's bytes below its
# length and the pow2 bank: the glue holds it to those ranges and returns
# the count of reads outside them.
_GLUE = """
extern "C" long emu_crc_lanes(const uint8_t *in, int64_t stride, int64_t width,
                              const int32_t *lens, int32_t lanes, int64_t seg,
                              const uint32_t *pow2, uint32_t *out, int rows) {
    emu_ldg_ranges.clear();
    for (int r = 0; r < rows; ++r) {
        const int64_t n = std::min<int64_t>(std::max<int64_t>(lens[r], 0), width);
        const char *row = reinterpret_cast<const char *>(in + r * stride);
        emu_ldg_ranges.push_back({row, row + n});
    }
    emu_ldg_ranges.push_back({reinterpret_cast<const char *>(pow2),
                              reinterpret_cast<const char *>(pow2 + 32 * 32)});
    emu_ldg_faults = 0;
    emu_launch_grid(lanes, rows, [&] {
        crc_lane_kernel(in, stride, width, lens, lanes, seg, pow2, out);
    });
    emu_ldg_ranges.clear();
    return emu_ldg_faults.load();
}
"""

# build name -> (threads, rounds a group); "card" is the source as it is
BUILDS = {"card": (512, 4), "small": (64, 2)}
POW2 = np.ascontiguousarray(gf2.shift_pow2_bank(32))


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        pytest.fail(f"no C++ compiler ({cxx}) to build the emulation")
    with open(SRC) as f:
        src = f.read()
    for pat, rep, times in _EDITS:
        src, n = re.subn(pat, rep, src)
        assert n == times, f"{pat!r} matched {n} times, want {times}"
    d = tmp_path_factory.mktemp("crc_emu")
    cmds, libs = [], {}
    for name, (threads, group) in BUILDS.items():
        defs = "" if name == "card" else (
            f"#define BZ3T_CRC_THREADS {threads}\n#define BZ3T_CRC_GROUP {group}\n")
        cpp = d / f"crc_emu_{name}.cpp"
        cpp.write_text(
            '#include "cuda_emu.h"\n'
            "thread_local unsigned char *smem;\n"
            "thread_local dim3i threadIdx, blockIdx;\n"
            f"dim3i blockDim{{{threads}}};\n"
            "thread_local EmuBarrier *emu_bars, *emu_warps;\n" + defs + src + _GLUE
        )
        libs[name] = d / f"libcrc_emu_{name}.so"
        cmds.append([cxx, "-std=c++17", "-O2", "-pthread", "-fPIC", "-shared", "-w", *EMU_FLAGS,
                     "-I", os.path.join(ROOT, "tests"), str(cpp), "-o", str(libs[name])])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out
    out = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.emu_crc_lanes.argtypes = [P, I64, I64, P, I32, I64, P, P, ctypes.c_int]
        lib.emu_crc_lanes.restype = ctypes.c_long
        out[name] = lib
    return out


def emu_lane_scan(lib, data: np.ndarray, lens: np.ndarray, lanes: int) -> np.ndarray:
    """Emulated K4 on rows data [K, N], copied to a width that is a
    multiple of 16 as the wrapper does: [K, lanes'] int64.  Fails if the
    kernel read a byte at or past a row's length."""
    k, n = data.shape
    lanes, seg = crc32.lane_layout(n, lanes)
    src = np.zeros((k, -(-max(n, 1) // 16) * 16), np.uint8)
    src[:, :n] = data
    out = np.full((k, lanes), 0xA5A5A5A5, np.uint32)
    bad = lib.emu_crc_lanes(src.ctypes.data, src.shape[1], n, lens.ctypes.data, lanes, seg,
                            POW2.ctypes.data, out.ctypes.data, k)
    assert bad == 0, f"{bad} reads at or past a row's length or outside the pow2 bank"
    return out.astype(np.int64)


# case -> (build, width, lengths, lanes, fill); every row random past its
# length, and random (or 0xFF) before it
CASES = {
    # rows shorter than one unit, one unit +- 1, width not a multiple of 16
    "short_lengths": ("card", 40, [0, 1, 15, 16, 17, 40], 1, "random"),
    # lanes of 143 bytes: every lane start and end inside a unit
    "misaligned_lanes": ("card", 1000, [1000, 999, 517, 0], 7, "random"),
    # lengths at a lane boundary +- 1, 1024-byte lanes
    "lane_boundary": ("card", 4096, [1023, 1024, 1025, 2047, 4096], 4, "random"),
    # one round of 512 units +- a unit and a byte, one lane a row
    "round_boundary": ("card", 8192, [8192, 8191, 8177, 8176, 8160], 1, "random"),
    # bit 31 of the states from the first step on
    "ones": ("card", 3000, [3000, 2999, 64], 3, "ones"),
    # 64 threads (a CTA of 512 threads is one std::thread each, so the
    # cases of many lanes run on the small build): one lane a byte
    # (lane_layout's cap); 128 lanes of 33 bytes, lanes past the width
    "lane_per_byte": ("small", 20, [20, 7], 64, "random"),
    "lanes_128": ("small", 4100, [4100, 3000], 128, "random"),
    # 2 rounds a group: 1 KiB rounds, several groups a lane
    "groups": ("small", 8192, [8192, 8191, 5001, 1], 2, "random"),
    "groups_misaligned": ("small", 7000, [7000, 6999, 4097], 3, "ones"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k4_source_against_plain_scan_and_oracle(emu, case):
    build, width, lengths, lanes, fill = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    data = rng.integers(0, 256, (len(lengths), width), dtype=np.uint8)
    clean = data.copy()
    for i, n in enumerate(lengths):
        if fill == "ones":
            data[i, :n] = 0xFF
        clean[i, n:] = 0
        clean[i, :n] = data[i, :n]
    lens = np.array(lengths, np.int32)
    got = emu_lane_scan(emu[build], data, lens, lanes)
    want = crc32.crc_lane_scan(torch.from_numpy(data), torch.from_numpy(lens), lanes)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got, want.numpy())
    crcs = crc32.crc32_from_lanes(torch.from_numpy(got), width, torch.from_numpy(lens))
    assert crcs.tolist() == [ref_crc32(clean[i, :n].tobytes()) for i, n in enumerate(lengths)]
    if fill == "ones":
        assert (got >= 1 << 31).any()
