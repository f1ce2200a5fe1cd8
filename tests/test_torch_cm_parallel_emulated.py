"""The CUDA source of P1 and P2, the parallel CM encoder's kernels
(``bzip3_tpu_torch/csrc/cm_parallel_kernels.cu``), run on the CPU under a
host emulation of the CUDA built-ins (``tests/cuda_emu.h``: one thread
per CUDA thread, ``__syncwarp`` as a counting barrier), against their
plain PyTorch versions (``ops/device/cm_parallel.py``), integer for
integer and byte for byte (tolerance 0).

P1 runs in its three modes on sorted event streams of <= 2,048 events
at seg 16-128 (every rate, window 0's arbitrary entry, padding events
that reset); P2 on rows of several 128-word chunks, whole and capped
below the payload (its true length reported); then the whole encoder
over the emulated P1 and P2 against the oracle coder.  Every ``__ldg``
must stay inside the event stream (P1) or below each row's 8 * length
words (P2, ``emu_ldg_ranges``).  The emulation says nothing of speed;
the chip smoke test holds the kernels themselves against the plain
versions.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bzip3_tpu.ops.ref.cm import cm_encode as ref_cm_encode
from bzip3_tpu_torch.ops.device import cm_parallel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "bzip3_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "cm_parallel_kernels.cu")

# (pattern, replacement, times it must match) turning the CUDA source into C++
_EDITS = [
    (r"#include <cuda_runtime.h>", "", 1),
    (r"<<<[^>]*>>>", "", 2),
    (r"extern __shared__ __align__\(16\) unsigned char smem\[\];", "", 1),
]

# Each launch holds __ldg to the ranges the kernel may read and returns
# the count of reads outside them.
_GLUE = """
extern "C" long emu_chain_windows(const uint32_t *ev, int64_t rows, int32_t seg, int32_t nwin,
                                  int32_t rate, int32_t mode, const int32_t *in0,
                                  const int32_t *in1, int32_t *out0, int32_t *out1) {
    emu_ldg_ranges.assign({{reinterpret_cast<const char *>(ev),
                            reinterpret_cast<const char *>(ev + rows * seg * nwin)}});
    emu_ldg_faults = 0;
    blockDim.x = kWinThreads;
    const int64_t threads = rows * nwin * (mode == kMap ? 1 << rate : 1);
    emu_launch((int)((threads + kWinThreads - 1) / kWinThreads), [&] {
        chain_windows_kernel(ev, rows, seg, nwin, rate, mode, in0, in1, out0, out1);
    });
    return emu_ldg_faults;
}
extern "C" long emu_range_pass(const uint32_t *words, int64_t stride, const int32_t *lens,
                               uint8_t *out, int32_t out_width, int32_t *out_lens, int rows) {
    emu_ldg_ranges.clear();
    for (int r = 0; r < rows; ++r) {
        const int64_t n = std::min<int64_t>(std::max<int64_t>(lens[r], 0), stride / 8);
        const char *row = reinterpret_cast<const char *>(words + r * stride);
        emu_ldg_ranges.push_back({row, row + 32 * n});
    }
    emu_ldg_faults = 0;
    blockDim.x = 32;
    emu_launch(rows, [&] {
        range_pass_kernel(words, stride, lens, out, out_width, out_width, out_lens);
    });
    return emu_ldg_faults;
}
"""


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
    d = tmp_path_factory.mktemp("cm_parallel_emu")
    cpp = d / "cm_parallel_emu.cpp"
    cpp.write_text(
        '#include "cuda_emu.h"\n'
        "thread_local unsigned char *smem;\n"
        "thread_local dim3i threadIdx, blockIdx;\n"
        "dim3i blockDim{256};\n"
        "thread_local EmuBarrier *emu_bars, *emu_warps;\n" + src + _GLUE
    )
    so = d / "libcm_parallel_emu.so"
    res = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-pthread", "-fPIC", "-shared", "-w",
         "-I", os.path.join(ROOT, "tests"), "-I", CSRC, str(cpp), "-o", str(so)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.emu_chain_windows.argtypes = [P, I64, I32, I32, I32, I32, P, P, P, P]
    lib.emu_chain_windows.restype = ctypes.c_long
    lib.emu_range_pass.argtypes = [P, I64, P, P, I32, P, ctypes.c_int]
    lib.emu_range_pass.restype = ctypes.c_long
    return lib


class Emulated:
    """P1 and P2 as ``cm_parallel.cm_encode_parallel_batch`` calls them,
    through the emulated kernels."""

    def __init__(self, lib):
        self.lib = lib

    def chain_windows(self, ev, rate, mode, in0, in1=None):
        k, seg, s = ev.shape
        ev, in0 = ev.contiguous(), in0.contiguous()
        in1 = in0 if in1 is None else in1.contiguous()
        if mode == "pair":
            outs = [torch.empty((k, s), dtype=torch.int32) for _ in range(2)]
        elif mode == "map":
            outs = [torch.empty((k, s, 1 << rate), dtype=torch.int32)]
        else:
            outs = [torch.empty((k, seg, s), dtype=torch.int32)]
        faults = self.lib.emu_chain_windows(
            ev.data_ptr(), k, seg, s, rate, cm_parallel.MODES.index(mode), in0.data_ptr(),
            in1.data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr())
        assert faults == 0, f"{faults} reads outside the event stream"
        return tuple(outs) if mode == "pair" else outs[0]

    def range_pass(self, words, lengths, out_width):
        k, n8 = words.shape
        out = torch.zeros((k, out_width), dtype=torch.uint8)
        out_lens = torch.zeros(k, dtype=torch.int32)
        faults = self.lib.emu_range_pass(words.data_ptr(), n8, lengths.data_ptr(), out.data_ptr(),
                                         out_width, out_lens.data_ptr(), k)
        assert faults == 0, f"{faults} reads at or past a row's bits"
        return out, out_lens


def _stream(rate: int, k: int, seg: int, s: int, seed: int) -> torch.Tensor:
    """A sorted, packed event stream [k, seg, s] (scan-major): groups of
    random lengths (some longer than a window) with their init values,
    reads that do not advance, and padding events at each row's end."""
    rng = np.random.default_rng(seed)
    e = seg * s
    ev = np.zeros((k, e), np.int64)
    for r in range(k):
        starts = np.zeros(e, bool)
        starts[0] = True
        starts[rng.choice(np.arange(1, e), size=e // 60, replace=False)] = True
        init = rng.integers(0, 65536, e)
        bit = rng.random(e) < 0.6
        adv = rng.random(e) < (0.5 if rate == 4 else 1.0)
        ev[r] = (init | (bit << 16) | (adv << 17) | (starts << 18))
        ev[r, e - seg // 3 :] = cm_parallel.START  # padding
    return torch.from_numpy(ev.astype(np.int32)).view(k, s, seg).transpose(1, 2).contiguous()


# P1 in each mode at each rate: 2 rows of 8 windows, seg 16-128 (<= 2,048
# events), entries from the bracket, from random values (window 0's entry
# is arbitrary) and at the top of the domain for the map's clipped samples.
@pytest.mark.parametrize("mode", cm_parallel.MODES)
@pytest.mark.parametrize("rate,seg", [(2, 16), (4, 64), (6, 128)])
def test_p1_source_matches_plain(emu, mode, rate, seg):
    k, s = 2, 8
    ev = _stream(rate, k, seg, s, seed=rate + seg)
    rng = np.random.default_rng(seg)
    lo = torch.from_numpy(rng.integers(0, 65536, (k, s)).astype(np.int32))
    lo[1, :2] = 65535 - (1 << rate) // 2
    hi = torch.maximum(lo, torch.from_numpy(rng.integers(0, 65536, (k, s)).astype(np.int32)))
    got = Emulated(emu).chain_windows(ev, rate, mode, lo, hi)
    want = cm_parallel.chain_windows_plain(ev, rate, mode, lo, hi)
    for g, w in zip(got if mode == "pair" else [got], want if mode == "pair" else [want]):
        assert g.shape == w.shape
        assert torch.equal(g, w)


def _words(k: int, n: int, seed: int) -> torch.Tensor:
    """Split factors in [1, 2^18) with random bits in bit 31; some rows
    confident (factors near the ends), so that renorms shift 0-4 bytes."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 1 << 18, (k, 8 * n))
    w[0] = np.where(rng.random(8 * n) < 0.5, 1 << 17, w[0])
    w[1] = rng.choice([1, 4, (1 << 18) - 5, (1 << 18) - 1], 8 * n)
    bit = rng.random((k, 8 * n)) < 0.5
    return torch.from_numpy((w | (bit.astype(np.int64) << 31)).astype(np.uint32).view(np.int32))


# P2 on 5 rows of up to 50 bytes (400 bits: 3 chunks and a part), lengths
# that end mid-chunk and 0; whole, and capped below most payloads.
@pytest.mark.parametrize("cap", [None, 24])
def test_p2_source_matches_plain(emu, cap):
    words = _words(5, 50, seed=3)
    lens = torch.tensor([50, 37, 50, 0, 17], dtype=torch.int32)
    width = 50 + 50 // 8 + 64 if cap is None else cap
    out, out_lens = Emulated(emu).range_pass(words, lens, width)
    want, want_lens = cm_parallel.range_pass_plain(words, lens, width)
    assert torch.equal(out_lens, want_lens)
    if cap is not None:
        assert (out_lens > cap).sum() >= 3
    for i in range(5):
        m = min(int(want_lens[i]), width)
        assert torch.equal(out[i, :m], want[i, :m]), f"row {i}"


def test_encoder_over_emulated_kernels_equals_oracle(emu):
    """The whole encoder with P1 and P2 emulated, at seg 64 (C2's map over
    40 windows of 64 samples): rows of 160, 90 and 0 bytes."""
    rng = np.random.default_rng(9)
    rows = [bytes(rng.choice(np.frombuffer(b"aab", np.uint8), 160)), b"hello, world " * 7, b""]
    arr = np.zeros((3, 160), np.uint8)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = np.frombuffer(r, np.uint8)
    lens = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    out, olens, ok = cm_parallel.cm_encode_parallel_batch(
        torch.from_numpy(arr), lens, seg=64, kernels=Emulated(emu))
    assert ok.all()
    for i, r in enumerate(rows):
        assert out[i, : olens[i]].numpy().tobytes() == ref_cm_encode(r), f"row {i}"
