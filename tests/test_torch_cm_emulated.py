"""The CUDA source of K1, K2 and their resumable forms K3a-K3c
(``bzip3_tpu_torch/csrc/cm_kernels.cu``) run on the CPU under a host
emulation of the CUDA built-ins (``tests/cuda_emu.h``: one thread per
CUDA thread, counting barriers), against the plain PyTorch coders, byte
for byte (tolerance 0).

A CUDA kernel cannot run here, but the kernels' logic can: K1's ring of
split factors between its model warp and its coder warp with the named
barriers that hand slots over, K2's tree of node predictions, its walk
and its payload window, both coders' closed-form renorm, the output cap
and stream exhaustion; and K3a-K3c's launches of a few steps each, with
the row's tables and registers carried in the state buffer.  A barrier protocol that would hang on the card aborts the
emulation (a count that differs between arrivals, or 20 s of waiting).
The emulation says nothing of speed or of the compiled SASS; the chip
smoke test holds the kernels themselves against the plain versions.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bzip3_tpu_torch.ops.device import cm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "bzip3_tpu_torch", "csrc", "cm_kernels.cu")

# (pattern, replacement, times it must match) turning the CUDA source into C++
_EDITS = [
    (r"#include <cuda_runtime.h>", "", 1),
    (r"<<<[^>]*>>>", "", 4),
    (r'asm volatile\("bar\.sync[^;]*;[^;]*;', "emu_bar(id, count, true);", 1),
    (r'asm volatile\("bar\.arrive[^;]*;[^;]*;', "emu_bar(id, count, false);", 1),
    (r"extern __shared__ __align__\(16\) unsigned char smem\[\];", "", 4),
]

_GLUE = """
extern "C" void emu_cm_encode(const uint8_t *in, int64_t stride, const int32_t *lens,
                              uint8_t *out, int32_t out_width, int32_t *out_lens, int rows) {
    emu_launch(rows, [&] {
        cm_encode_kernel(in, stride, stride, lens, out, out_width, out_width, out_lens);
    });
}
extern "C" void emu_cm_decode(const uint8_t *in, int64_t stride, const int32_t *in_lens,
                              const int32_t *out_lens, uint8_t *out, int64_t out_width, int rows) {
    emu_launch(rows, [&] {
        cm_decode_kernel(in, stride, stride, in_lens, out_lens, out, out_width);
    });
}
extern "C" void emu_cm_encode_resume(const uint8_t *in, int64_t stride, const int32_t *lens,
                                     uint8_t *out, int32_t out_width, int32_t *out_lens,
                                     uint8_t *state, int32_t start, int32_t stop, int rows) {
    emu_launch(rows, [&] {
        cm_encode_resume_kernel(in, stride, stride, lens, out, out_width, out_width, out_lens,
                                state, start, stop);
    });
}
extern "C" void emu_cm_decode_resume(const uint8_t *in, int64_t stride, const int32_t *in_lens,
                                     const int32_t *out_lens, int32_t out_width, uint8_t *out,
                                     int64_t out_stride, int32_t out_rel, uint8_t *state,
                                     int32_t start, int32_t stop, int rows) {
    emu_launch(rows, [&] {
        cm_decode_resume_kernel(in, stride, stride, in_lens, out_lens, out_width, out, out_stride,
                                out_rel, state, start, stop);
    });
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
    d = tmp_path_factory.mktemp("cm_emu")
    cpp = d / "cm_emu.cpp"
    cpp.write_text(
        '#include "cuda_emu.h"\n'
        "thread_local unsigned char *smem;\n"
        "thread_local dim3i threadIdx, blockIdx;\n"
        "dim3i blockDim{256};\n"
        "thread_local EmuBarrier *emu_bars, *emu_warps;\n" + src + _GLUE
    )
    so = d / "libcm_emu.so"
    res = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-pthread", "-fPIC", "-shared", "-w",
         "-I", os.path.join(ROOT, "tests"), "-I", os.path.dirname(SRC), str(cpp), "-o", str(so)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.emu_cm_encode.argtypes = [P, I64, P, P, I32, P, ctypes.c_int]
    lib.emu_cm_decode.argtypes = [P, I64, P, P, P, I64, ctypes.c_int]
    lib.emu_cm_encode_resume.argtypes = [P, I64, P, P, I32, P, P, I32, I32, ctypes.c_int]
    lib.emu_cm_decode_resume.argtypes = [P, I64, P, P, I32, P, I64, I32, P, I32, I32, ctypes.c_int]
    lib.bz3t_cm_state_bytes.restype = I64
    return lib


def _rows(n: int) -> list[bytes]:
    """chip_smoke.py's parity rows at width n: random, a confident model
    that meets a surprise, a run flag that switches on and off, runs,
    constants, a 1-byte and an empty row."""
    rng = np.random.default_rng(11)
    return [
        rng.integers(0, 256, n // 2, dtype=np.uint8).tobytes(),
        bytes(n // 2) + rng.integers(0, 256, n // 2, dtype=np.uint8).tobytes(),
        (b"ab" * (n // 4) + b"a" * (n // 4))[:n],
        b"abcabcabc" * (n // 9),
        b"\x00" * n,
        b"\xff" * 130,
        b"Q",
        b"",
        np.repeat(rng.integers(0, 4, 256, dtype=np.uint8), rng.integers(1, 40, 256))[:n].tobytes(),
    ]


def _pad(rows, width):
    arr = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return arr, lens


def _emu_encode(lib, arr, lens, out_width):
    out = np.zeros((arr.shape[0], out_width), np.uint8)
    out_lens = np.zeros(arr.shape[0], np.int32)
    lib.emu_cm_encode(arr.ctypes.data, arr.shape[1], lens.ctypes.data, out.ctypes.data,
                      out_width, out_lens.ctypes.data, arr.shape[0])
    return out, out_lens


@pytest.fixture(scope="module")
def k1_rows(emu):
    """The parity rows at 2,608 steps and emulated K1's payloads of them
    at the default width, which the K1 and K3a cases share."""
    n = 2608
    arr, lens = _pad(_rows(n), n)
    return (arr, lens, *_emu_encode(emu, arr, lens, n + n // 8 + 64))


# K1 over 2,608 steps: more than the ring's 4 slots of 256 bytes, so the
# model warp waits for slots the coder has freed; the cap of half the
# width cuts the random rows' payloads.
@pytest.mark.parametrize("cap", [None, 1304])
def test_k1_source_matches_plain_encoder(emu, k1_rows, cap):
    arr, lens, k1, k1_lens = k1_rows
    want, want_lens = cm.cm_encode_batch(torch.from_numpy(arr), torch.from_numpy(lens), cap)
    want, want_lens = want.numpy(), want_lens.numpy()
    out, out_lens = (k1, k1_lens) if cap is None else _emu_encode(emu, arr, lens, want.shape[1])
    np.testing.assert_array_equal(out_lens, want_lens)
    if cap is not None:
        assert (out_lens > cap).any()
    for i in range(len(lens)):
        m = min(int(want_lens[i]), want.shape[1])
        assert out[i, :m].tobytes() == want[i, :m].tobytes(), f"row {i}"


# K2 over 608 steps on K1's payloads, whole or cut short (the random
# rows run out of input halfway; one row keeps 2 bytes of its payload).
@pytest.mark.parametrize("cut", [False, True])
def test_k2_source_matches_plain_decoder(emu, cut):
    n = 608
    rows = _rows(n)
    arr, lens = _pad(rows, n)
    pay, pay_lens = _emu_encode(emu, arr, lens, n + n // 8 + 64)
    pays = [pay[i, : pay_lens[i]].tobytes() for i in range(len(rows))]
    if cut:
        pays[0], pays[1], pays[3] = pays[0][: len(pays[0]) // 2], pays[1][: len(pays[1]) // 2], pays[3][:2]
    parr, plens = _pad(pays, -(-max(map(len, pays)) // 16) * 16)
    want = cm.cm_decode_batch(torch.from_numpy(parr), torch.from_numpy(plens),
                              torch.from_numpy(lens), n).numpy()
    out = np.zeros((len(rows), n), np.uint8)
    emu.emu_cm_decode(parr.ctypes.data, parr.shape[1], plens.ctypes.data, lens.ctypes.data,
                      out.ctypes.data, n, len(rows))
    for i in range(len(rows)):
        assert out[i, : lens[i]].tobytes() == want[i, : lens[i]].tobytes(), f"row {i}"
        if not cut:
            assert out[i, : lens[i]].tobytes() == rows[i], f"row {i}"


def _emu_encode_resume(lib, arr, lens, out_width, chunk):
    """K3a in launches of ``chunk`` steps, the state buffer (as from
    ``torch.empty``: filled with junk) carried between them as in
    ``cm_cuda``."""
    k, n = arr.shape
    out = np.zeros((k, out_width), np.uint8)
    out_lens = np.zeros(k, np.int32)
    state = np.full((k, lib.bz3t_cm_state_bytes()), 0x5A, np.uint8)
    for s, e in cm.windows(n, chunk):
        lib.emu_cm_encode_resume(arr.ctypes.data, n, lens.ctypes.data, out.ctypes.data,
                                 out_width, out_lens.ctypes.data, state.ctypes.data, s, e, k)
    return out, out_lens


def _emu_decode_resume(lib, parr, plens, lens, n, chunk, rel):
    """K3b (one [K, n] output) or, with ``rel``, K3c (a [K, stop - start]
    piece a launch) in launches of ``chunk`` steps: [(start, output)]."""
    k = parr.shape[0]
    state = np.full((k, lib.bz3t_cm_state_bytes()), 0x5A, np.uint8)
    out, res = np.zeros((k, n), np.uint8), []
    for s, e in cm.windows(n, chunk):
        if rel:
            out = np.zeros((k, e - s), np.uint8)
        lib.emu_cm_decode_resume(parr.ctypes.data, parr.shape[1], plens.ctypes.data,
                                 lens.ctypes.data, n, out.ctypes.data, out.shape[1], int(rel),
                                 state.ctypes.data, s, e, k)
        res.append((s, out))
    return res


# K3a in launches of 1,088 steps: the ring of 4 slots of 256 bytes wraps
# inside a launch, and its slots and barriers restart in the next.  The
# cap of half the width cuts the random rows' payloads (the true length
# is reported).
@pytest.mark.parametrize("cap", [None, 1304])
def test_k3a_source_matches_plain_and_k1(emu, k1_rows, cap):
    arr, lens, k1, k1_lens = k1_rows
    want, want_lens = (t.numpy() for t in cm.cm_encode_resumable(
        torch.from_numpy(arr), torch.from_numpy(lens), cap, chunk_steps=1088))
    out, out_lens = _emu_encode_resume(emu, arr, lens, want.shape[1], 1088)
    np.testing.assert_array_equal(out_lens, want_lens)
    np.testing.assert_array_equal(k1_lens, want_lens)
    if cap is not None:
        assert (out_lens > cap).any()
    for i in range(len(lens)):
        m = min(int(want_lens[i]), want.shape[1])
        assert out[i, :m].tobytes() == want[i, :m].tobytes() == k1[i, :m].tobytes(), f"row {i}"


@pytest.fixture(scope="module")
def dec_rows(emu):
    """304 steps of the parity rows, their payloads, two of them cut in
    half (one runs out of input in the first launch of 128 steps, one in
    the second) and one to 2 bytes; and emulated K2 in one launch."""
    n = 304
    rows = _rows(n)
    arr, lens = _pad(rows, n)
    pay, pay_lens = cm.cm_encode_batch(torch.from_numpy(arr), torch.from_numpy(lens))
    pays = [pay[i, : pay_lens[i]].numpy().tobytes() for i in range(len(rows))]
    pays[0], pays[1], pays[3] = pays[0][: len(pays[0]) // 2], pays[1][: len(pays[1]) // 2], pays[3][:2]
    parr, plens = _pad(pays, -(-max(map(len, pays)) // 16) * 16)
    k2 = np.zeros((len(rows), n), np.uint8)
    emu.emu_cm_decode(parr.ctypes.data, parr.shape[1], plens.ctypes.data, lens.ctypes.data,
                      k2.ctypes.data, n, len(rows))
    for i in (2, 4, 5, 6, 7, 8):
        assert k2[i, : lens[i]].tobytes() == rows[i], f"row {i}"
    return lens, parr, plens, k2


# K3b and K3c in launches of 128 steps: the 1-byte and the empty row end
# in the first launch, the 130-byte row early in the second; K3c yields
# one piece a launch.
@pytest.mark.parametrize("rel", [False, True])
def test_k3b_k3c_source_match_plain_and_k2(emu, dec_rows, rel):
    lens, parr, plens, k2 = dec_rows
    n, chunk = k2.shape[1], 128
    args = (torch.from_numpy(parr), torch.from_numpy(plens), torch.from_numpy(lens), n, chunk)
    got = _emu_decode_resume(emu, parr, plens, lens, n, chunk, rel)
    if rel:
        want = [(s, p.numpy()) for s, p in cm.cm_decode_stream(*args)]
    else:
        got, want = [(0, got[-1][1])], [(0, cm.cm_decode_resumable(*args).numpy())]
    assert [s for s, _ in got] == [s for s, _ in want] == ([0, 128, 256] if rel else [0])
    for (s, g), (_, w) in zip(got, want):
        for i in range(len(lens)):
            m = max(0, min(int(lens[i]) - s, g.shape[1]))
            assert g[i, :m].tobytes() == w[i, :m].tobytes() == k2[i, s : s + m].tobytes(), \
                f"row {i} at {s}"


def test_kernel_resources_read_ptxas_lines():
    """The chip smoke test's build phase reads each kernel's registers,
    static shared memory and spills from nvcc's ``-Xptxas -v`` lines,
    whose kernel names are mangled inside the file's unnamed namespace."""
    from bzip3_tpu_torch.ops import build

    ns = "_ZN46_GLOBAL__N__db0150a9_13_cm_kernels_cu_8a0719b5"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{ns}16cm_encode_kernelEPKhllPKiPhliPi' for 'sm_90a'",
        f"ptxas info    : Function properties for {ns}16cm_encode_kernelEPKhllPKiPhliPi",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z15crc_lane_kernelPKh' for 'sm_90a'",
        "ptxas info    : Used 28 registers, 1024 bytes smem, 400 bytes cmem[0]",
    ])
    assert build.kernel_resources(log) == {
        "cm_encode_kernel": {"spill_stores": 8, "spill_loads": 4, "registers": 40, "smem": 0},
        "crc_lane_kernel": {"registers": 28, "smem": 1024},
    }
