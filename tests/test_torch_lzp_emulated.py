"""The CUDA source of K5 and K6 (``bzip3_tpu_torch/csrc/lzp_kernels.cu``:
LZP encode and decode, one warp a row over speculative windows of 32
positions) run on the CPU under a host emulation of the CUDA built-ins
(``tests/cuda_emu.h``: one thread per CUDA thread, the warp collectives
as exchanges between counting barriers), against the plain PyTorch
version (``ops/device/lzp.py``) and the JAX package's oracle
(``bzip3_tpu/ops/ref/lzp.py``), byte for byte (tolerance 0).

One case per hazard of the windows (the rows of
``chip_smoke.lzp_hazards``, each <= 4 KiB, which the chip smoke test
also runs on the card): equal hashes inside a window, a match at each
lane offset, an extension that stops at scan_end, a heur rejection
followed by a match, 0xF2 in every lane, out_cap at every lane offset,
overlapping copies at distances 1..33 and max_out inside them, truncated
tokens; and the chip smoke test's other LZP rows.  The emulation says
nothing of speed; the chip smoke test holds the kernels themselves
against the plain version.
"""

import ctypes
import os
import shlex
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bzip3_tpu.ops.ref.lzp import lzp_decode as ref_decode
from bzip3_tpu.ops.ref.lzp import lzp_encode as ref_encode
from bzip3_tpu_torch.ops.device import lzp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# extra compiler flags for the emulation (scripts/torch_sanitize.py --emulated
# builds it under ASan/UBSan)
EMU_FLAGS = shlex.split(os.environ.get("BZ3_EMU_CXXFLAGS", ""))
SRC = os.path.join(ROOT, "bzip3_tpu_torch", "csrc", "lzp_kernels.cu")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the hazard rows; it imports only numpy at the top)

# (pattern, replacement, times it must match) turning the CUDA source into C++
_EDITS = [
    (r"#include <cuda_runtime.h>", "", 1),
    (r"<<<[^>]*>>>", "", 2),
    (r"extern __shared__ __align__\(16\) unsigned char smem\[\];", "", 2),
]

_GLUE = """
extern "C" void emu_lzp_encode(const uint8_t *in, int64_t stride, const int32_t *lens,
                               uint8_t *out, int64_t out_width, int32_t *luts,
                               int32_t *out_lens, int32_t *stats, int rows) {
    emu_launch(rows, [&] {
        lzp_encode_kernel(in, stride, stride, lens, out, out_width, luts, out_lens, stats);
    });
}
extern "C" void emu_lzp_decode(const uint8_t *in, int64_t stride, const int32_t *in_lens,
                               uint8_t *out, int64_t out_width, int32_t max_out,
                               int32_t *luts, int32_t *out_lens, int32_t *stats, int rows) {
    emu_launch(rows, [&] {
        lzp_decode_kernel(in, stride, stride, in_lens, out, out_width, max_out, luts, out_lens,
                          stats);
    });
}
"""

STATS = 5  # counters a row


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
    d = tmp_path_factory.mktemp("lzp_emu")
    cpp = d / "lzp_emu.cpp"
    cpp.write_text(
        '#include "cuda_emu.h"\n'
        "thread_local unsigned char *smem;\n"
        "thread_local dim3i threadIdx, blockIdx;\n"
        "dim3i blockDim{32};\n"
        "thread_local EmuBarrier *emu_bars, *emu_warps;\n" + src + _GLUE
    )
    so = d / "liblzp_emu.so"
    res = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-pthread", "-fPIC", "-shared", "-w", *EMU_FLAGS,
         "-I", os.path.join(ROOT, "tests"), str(cpp), "-o", str(so)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.emu_lzp_encode.argtypes = [P, I64, P, P, I64, P, P, P, ctypes.c_int]
    lib.emu_lzp_decode.argtypes = [P, I64, P, P, I64, I32, P, P, P, ctypes.c_int]
    return lib


def _pad(rows, width):
    arr = np.zeros((len(rows), max(width, 1)), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return arr, lens


def emu_encode(lib, rows):
    """Emulated K5 on rows: ([stream or None], stats [K, 4])."""
    arr, lens = _pad(rows, max(map(len, rows)))
    k, n = arr.shape
    w = n + lzp.OUT_PAD
    out = np.full((k, w), 0xA5, np.uint8)
    out_lens = np.zeros(k, np.int32)
    stats = np.zeros((k, STATS), np.int32)
    luts = np.zeros((k, 1 << lzp.LZP_BITS), np.int32)
    lib.emu_lzp_encode(arr.ctypes.data, n, lens.ctypes.data, out.ctypes.data, w,
                       luts.ctypes.data, out_lens.ctypes.data, stats.ctypes.data, k)
    return [None if m < 0 else out[i, :m].tobytes() for i, m in enumerate(out_lens)], stats


def emu_decode(lib, streams, max_out):
    """Emulated K6 on streams: ([row or None], stats [K, 4])."""
    arr, lens = _pad(streams, max(map(len, streams)))
    k, m = arr.shape
    out = np.full((k, max_out), 0xA5, np.uint8)
    out_lens = np.zeros(k, np.int32)
    stats = np.zeros((k, STATS), np.int32)
    luts = np.zeros((k, 1 << lzp.LZP_BITS), np.int32)
    lib.emu_lzp_decode(arr.ctypes.data, m, lens.ctypes.data, out.ctypes.data, max_out, max_out,
                       luts.ctypes.data, out_lens.ctypes.data, stats.ctypes.data, k)
    return [None if v < 0 else out[i, :v].tobytes() for i, v in enumerate(out_lens)], stats


def _check_encode(lib, rows):
    got, stats = emu_encode(lib, rows)
    for i, r in enumerate(rows):
        want = lzp.encode_row(r)
        assert want == ref_encode(r), f"plain and oracle differ on row {i}"
        assert got[i] == want, f"K5 differs on row {i} ({len(r)} bytes)"
    return got, stats


def _check_decode(lib, streams, max_out):
    got, stats = emu_decode(lib, streams, max_out)
    for i, s in enumerate(streams):
        want = lzp.decode_row(s, max_out)
        assert want == ref_decode(s, max_out), f"plain and oracle differ on stream {i}"
        assert got[i] == want, f"K6 differs on stream {i} ({len(s)} bytes, max_out {max_out})"
    return got, stats


HAZARDS = chip_smoke.lzp_hazards()


@pytest.mark.parametrize("hazard", list(HAZARDS))
def test_k5_k6_source_on_window_hazards(emu, hazard):
    rows = HAZARDS[hazard]
    enc, stats = _check_encode(emu, rows)
    streams = [e for e in enc if e is not None]
    assert streams or hazard == "out_cap"
    if hazard == "out_cap":  # out_cap reached at every lane offset, and not reached
        assert None in enc and streams
        streams = rows  # raw bytes as streams: arbitrary decoder input
    # each stream back to its row, then cut at max_out inside the rows
    back, dstats = _check_decode(emu, streams, 4096)
    if hazard != "out_cap":
        assert back == [r for r, e in zip(rows, enc) if e is not None]
    for cut in (5, 37, 100, 131):
        _check_decode(emu, streams, cut)
    events, matches = stats[:, 1], stats[:, 3]
    if hazard == "heur_then_match":
        assert ((events > matches) & (matches > 0)).all(), stats.tolist()
    if hazard == "lane_offsets":
        assert (matches >= 1).all(), stats.tolist()
    if hazard in ("copy_distances", "token_lanes"):
        assert (dstats[:, 1] > 0).any() and (dstats[:, 3] > 0).any(), dstats.tolist()


def test_k5_k6_source_on_smoke_rows_and_truncated_tokens(emu):
    rows = chip_smoke._lzp_cases()[:12]
    enc, _ = _check_encode(emu, rows)
    assert sum(e is not None for e in enc) >= 6
    streams = [e for e in enc if e is not None]
    back, _ = _check_decode(emu, streams + [b"", b"abc"], 4096)
    assert back[-2:] == [None, None]
    assert back[:-2] == [r for r, e in zip(rows, enc) if e is not None]
    cut, _ = _check_decode(emu, chip_smoke.lzp_streams(streams), 4096)
    assert None in cut
