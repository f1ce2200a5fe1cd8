#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bzip3_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper
card (the kernels are built for sm_90a).  Phases, each printing one
JSON line:

1. device  - the card's name and power limit (``nvidia-smi``);
2. build   - the CUDA kernels from ``bzip3_tpu_torch/csrc/*.cu`` into
             ``_build/torch_kernels/`` (nvcc), the host passes with g++;
             each kernel's registers, static shared memory and spills;
             beside them the pointer chase of scripts/torch_sm_latency.cu;
   latency - the L2 round trip (an 8 MiB table) and a device memory
             one (256 MiB) of a dependent load, one thread; the cycles
             of a warp's __match_any_sync; the range coder's bit step
             alone (P2's dependent chain, its serial bound);
3. parity  - K1 (CM encode) and K2 (CM decode) on the card against
             their plain PyTorch versions on CPU copies of the same
             10 rows (among them a confident model meeting random bytes,
             and a run flag switching on and off), byte for byte;
             K2(K1(x)) == x on two 1 MiB rows;
4. golden  - the reference-made ``tests/data/*.bz3`` decode on the
             card, and re-encode to the same bytes;
5. main    - 8 blocks x 16 MiB of seeded text through ``compress_file``
             / ``decompress_file`` at -b 16 on the card, with launch
             counts, stage times, throughput and peak device memory;
6. main_shapes - K1 and K2 on that path's own rows (post-prepass,
             post-BWT, [8, ~16 Mi]): timed, K2(K1(u)) == u, and each
             against its plain version on every row's first 2 KiB;
7. surface - the public surface around the main path at -b 16, on
             main's data and stream: ``Bz3Codec`` on one block (K1, K2
             and K4 at one row), ``test_file`` and ``python -m
             bzip3_tpu_torch -t`` on the stream (rc 0) and on a damaged
             one (rc 1), ``recover_file`` on four blocks, three damaged,
             each damaged block's bytes held against the same chain on
             the host C++ and the damaged LZP size driving K3b, and the
             native and hybrid engines, their streams equal to main's;
8. harden  - the hardening harnesses of ``examples/torch_*.py`` on the
             card with fixed seeds (``phase_harden``): the engine
             differential over the default, device-prepass and parallel
             routes, every block of it held whole to the oracle engine
             (``ops/ref``) on worker processes, the round-trip fuzz, ~600 damaged blocks through
             ``Bz3Codec`` and three batched routes (K6 on malformed LZP
             streams, K3a/K3c on the forced hybrid), 200 damaged frames,
             one damaged block decoded by K3b on the wave path, every
             outcome held to the native engine; then main's first block
             round-tripped again, and ``bin/torch/bz3cat`` and ``bz3grep``
             on main's stream;
9. parity_prepass - K4 (CRC lane scan), K5 (LZP encode) and K6 (LZP
             decode) against their plain versions on CPU copies of the
             same rows of <= 4 KiB (for K5/K6 also every hazard of their
             windows, ``lzp_hazards``, and K6 cut at max_out), byte for
             byte (K4 at three lane counts), K4's CRCs against the host
             C++, and each kernel's time a byte on one row;
10. main_prepass - the device prepass chain: 8 blocks x 16 MiB (text,
             log lines where LZP fires, a sparse block where RLE fires)
             through ``compress_file`` / ``decompress_file`` with
             ``device_prepass=True``; the stream must equal the default
             path's, with LZP and RLE each kept on some block;
11. prepass_shapes - K4, K5 and K6 on that phase's own [8, 16 Mi] rows,
             timed, each checked in full against the host C++ (and K4
             with the lane combine, as encode/crc runs it); K5/K6's
             windows and events of each row, their bounds by bytes and
             by the L2 round trip;
12. main_wave - one wave that fills the card: main's 8 blocks, main_prepass's
             8 and 16 blocks of fresh seeded text (32 x 16 MiB) through
             ``compress_file`` / ``decompress_file`` in one batch at -b 16:
             blocks 0-15 equal to main's and main_prepass's, one K1 and
             one K2 launch, the BWT and inverse groups, the host pool's
             waits and MiB/s; then K1 and K2 at [1, 1 Mi] and [SMs, 1 Mi]
             on post-BWT rows, and their ratio;
13. parity_resume - K3a, K3b and K3c (the resumable CM kernels) against
             their plain versions on CPU copies of the same rows, in
             launches of 256 steps, byte for byte, and against K1/K2;
14. main_b32 - the device path at -b 32: a text block and a log block
             of 32 MiB through ``compress_file`` / ``decompress_file``,
             CM-coded by K3a/K3b in two launches of 16 Mi steps, each
             launch timed with CUDA events as it runs; then K1 in one
             launch on the same rows must give the same payloads, K2 in
             one launch on them the rows K3b gave back (K3a/K3b against
             K1/K2, whose body they share, timed in one call), and K3b
             at the full width must equal the plain decoder on a prefix;
15. main_oversize - one 40 MiB block (text, log lines) at -b 40 past a
             device-block cap of 32 MiB set for the phase
             (BZ3_TPU_MAX_DEVICE_BLOCK_MIB): the host-BWT hybrid (host
             SA-IS, K3a, K3c, host inverse BWT), its launches timed as
             they run, its stream equal to the default path's at -b 40;
             the host SA-IS held against the device BWT, and K3a and K3c
             at the full width against the plain coders on a prefix; K3a's
             and K3c's ns a bit step against K1's and K2's from main_b32;
16. main_wide - 4 blocks of 144 MiB (text and log lines cut from the
             run's own pieces, no piece twice in a block) at -b 144
             through ``compress_file`` / ``decompress_file``: the wave
             path, not the hybrid, in one wave (K3a and K3b launched
             ceil(steps / 16 Mi) times for all rows), the BWT and
             inverse groups as planned, no row coded again, the first
             row's payload against the plain encoder on a prefix; stage
             times, MiB/s beside the hybrid's, peak memory;
17. main_wide_prepass - main_wide's blocks on the device chain
             (``device_prepass``): one wave, its RLE in the planned row
             groups and one K5 and one K6 launch, the stream equal to
             main_wide's, the round trip equal, peak device memory within
             the planned share;
18. wide_bwt - the forward and inverse BWT alone on one row of 256 MiB
             and one of 511 MiB: seconds and peak bytes a byte,
             inverse(forward(x)) == x, and the forward equal to the host
             SA-IS at 256 MiB;
19. parity_parallel - P1 (the chain window scans, each mode and rate)
             and P2 (the range pass) against their plain versions: the
             parallel CM encoder on the card and on the CPU over the
             same post-BWT hazard rows at seg 128 and 2048 and in the
             exact mode, every kernel call held against the CPU run's
             call on equal inputs, P2 again under an output cap; the
             card's runs under ``trace`` (torch.profiler), whose Chrome
             trace must name both kernels;
20. main_parallel - BZ3_TPU_CM=parallel at -b 2: 16 blocks x 2 MiB of
             text through ``compress_file`` / ``decompress_file``, P1
             and P2 timed launch by launch; the stream equal to the K1
             route's, no row coded again, the golden streams re-encoded
             on this route; then the encoder against K1 at [1, N] and
             [16, N] of post-BWT rows with its peak memory a byte, its
             stage times, and ``torch.sort`` alone at C1's key shape;
             and every P1 pass of the [16, N] encode against its plain
             version on the same card tensors, P2's payloads against
             the plain range pass on each row's first 4 KiB;
21. main_sharded - main's 8 x 16 MiB at -b 16 through the sharded
             engine, ``get_engine("sharded")`` (one share on one card),
             then through two shares of the card (two threads, two
             streams, 4 rows each): both streams equal to main's, one K1
             and one K2 a share a wave, each share's K1 and K2 from CUDA
             events on its stream, the overlap (the shares' K1 summed
             over ``encode/cm``'s wall time), stage times, MiB/s and peak
             memory; then BZ3_TPU_HOST_CRC=0 on 4 blocks of 1 MiB
             through the two shares (K4 in each), its stream equal to
             the host CRC's, and ``python -m bzip3_tpu_torch -e
             --engine sharded`` on those blocks, the same blocks;
22. multihost - two processes over gloo on the card, each coding its
             ``host_stripe`` of main's first 4 blocks, gathered to rank 0
             by ``gather_to_writer`` and equal to main's blocks; then one
             rank over NCCL (world size 1), at the same time,
             gathering main's blocks as rows on the card;
23. dryrun  - ``dryrun_multichip(2, "cuda:0")``.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a card, or outside a checkout of the repository, it
exits non-zero before printing any result.  About 16 minutes in all.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MiB = 1 << 20

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth,
# and the 32-bit non-tensor rate (67 TFLOP/s float32; the integer and
# logic operations of the CM coder issue on the same pipes at no more).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Integer and logic operations of one CM bit step in the kernels
# (predict: 3 counter loads, mix, SSE index, 2 loads, interpolation;
# range split: 64-bit product and shift; branch; renorm test; four
# counter updates; context update), counted from csrc/cm_kernels.cu.
OPS_PER_BIT = 40
# Operations of K4 a byte: a 16-byte unit takes one load, 16 table loads
# and 32 index operations (shift, mask), 18 xors, and its round shift 4
# table loads, 7 index operations and 4 xors: 82 a unit, 5 a byte
# (counted from csrc/crc32_kernels.cu); and of the LZP function's
# step a byte (hash: 3 shifts/xors and a mask; table load and store;
# tests of the slot and the token; byte load and store; context shift
# and or; loop tests): the serial state machine's work, which K5/K6's
# windows repeat speculatively (a window's lanes all gather and test).
OPS_PER_CRC_BYTE = 5
OPS_PER_LZP_STEP = 18
# Operations of one P1 event step on one state (start test and select,
# advance test and select, the counter step: xor, shift, add or subtract,
# the bit's select) and of one P2 bit step (mask and shift of the factor,
# the split's high product, the select of low or high, the renorm count
# and its cap test, four byte tests and stores, two funnel shifts, the
# count), counted from csrc/cm_parallel_kernels.cu.
OPS_PER_EVENT = 8
OPS_PER_P2_BIT = 16
# Where each kernel stands: "ported" (its first CUDA form) or
# "redesigned" (rebuilt for the card after it was ported).
STATUS = {"K1": "redesigned", "K2": "redesigned", "K3a": "redesigned", "K3b": "redesigned",
          "K3c": "redesigned", "K4": "redesigned", "K5": "redesigned", "K6": "redesigned",
          "P1": "ported", "P2": "ported"}
# The kernels of each main path; a main phase fails if one of them did
# not launch.
DEFAULT_PATH = ("cm_encode", "cm_decode")
PREPASS_PATH = ("cm_encode", "cm_decode", "crc_lanes", "lzp_encode", "lzp_decode")
B32_PATH = ("cm_encode_resume", "cm_decode_resume")
OVERSIZE_PATH = ("cm_encode_resume", "cm_decode_stream")
SURFACE_PATH = ("cm_encode", "cm_decode", "crc_lanes", "cm_decode_resume")
PARALLEL_PATH = ("chain_windows", "range_pass", "cm_decode")
# The reference-made streams under tests/data (bzip3 -e -b 1).
GOLDEN = ("sample_text.bin.bz3", "sample_mixed.bin.bz3")


def _require(cond, what) -> None:
    """Fail the smoke run (an exception, so -O cannot drop the check)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_corpus(size: int, seed: int = 0) -> bytes:
    """Deterministic text-like data with enwik-ish compressibility
    (a copy of bench.py's corpus generator)."""
    rng = np.random.default_rng(seed)
    vocab = []
    # synthetic vocabulary with zipf-ish frequencies
    letters = np.array(list(b"abcdefghijklmnopqrstuvwxyz"), dtype=np.uint8)
    for i in range(4096):
        ln = int(rng.integers(2, 11))
        vocab.append(bytes(rng.choice(letters, ln)))
    ranks = np.arange(1, len(vocab) + 1)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    markup = [b"<page>", b"</page>", b"[[", b"]]", b"{{", b"}}", b"==", b"&quot;"]
    parts = []
    total = 0
    idx = rng.choice(len(vocab), size=size // 5, p=probs)
    punct = rng.integers(0, 100, size=size // 5)
    for w, pn in zip(idx, punct):
        parts.append(vocab[w])
        if pn < 3:
            parts.append(markup[pn % len(markup)])
        elif pn < 6:
            parts.append(b". ")
        elif pn < 8:
            parts.append(str(int(pn) * 251).encode())
            parts.append(b" ")
        else:
            parts.append(b" ")
        total += 8
        if total >= size + 4096:
            break
    return b"".join(parts)[:size]


def corpus(size: int, seed: int) -> bytes:
    """Exactly ``size`` bytes of make_corpus text (make_corpus stops
    short of its size by some 5-10%)."""
    out = make_corpus(size + size // 4, seed)[:size]
    _require(len(out) == size, (len(out), size))
    return out


def _pad(rows, width):
    arr = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return arr, lens


def _cuda_ms(fn, reps: int, queue: bool = False) -> float:
    """Mean milliseconds of ``fn`` on the card between CUDA events.  With
    ``queue``, the calls are queued behind a sleeping kernel, so that the
    host's time to launch them leaves no gaps on the card (for a kernel
    shorter than its wrapper's Python)."""
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    if queue:
        torch.cuda._sleep(50_000_000)  # ~25 ms
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _row_diff(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max(initial=0))


def _bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _wrappers():
    from bzip3_tpu_torch.ops.device import cm_cuda, cm_parallel_cuda, crc32_cuda, lzp_cuda

    return cm_cuda, crc32_cuda, lzp_cuda, cm_parallel_cuda


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    for w in _wrappers():
        w.reset_launches()


def launch_counts() -> dict:
    return {k: v for w in _wrappers() for k, v in w.LAUNCHES.items()}


def phase_device(card: str) -> None:
    import torch

    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})


LATENCY_SO = os.path.join(ROOT, "_build", "sm_latency", "libsm_latency.so")
CODER_CHAIN_STEPS = 1 << 22  # bit steps of phase_latency's coder chain


def phase_build(card: str) -> dict:
    """The port's kernels and host passes, and beside them (its own nvcc,
    started first, so that the builds overlap) the pointer chase of
    scripts/torch_sm_latency.cu that phase_latency runs."""
    from bzip3_tpu_torch.ops import build

    os.makedirs(os.path.dirname(LATENCY_SO), exist_ok=True)
    chase = subprocess.Popen(
        [build._nvcc(), *build.NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
         os.path.join(ROOT, "scripts", "torch_sm_latency.cu"), "-o", LATENCY_SO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    try:
        build.load_kernels()
    finally:
        chase_log = chase.communicate(timeout=600)[0]
    t_kernels = time.perf_counter() - t0
    _require(chase.returncode == 0, f"scripts/torch_sm_latency.cu: {chase_log}")
    t0 = time.perf_counter()
    build.load_host()
    t_host = time.perf_counter() - t0
    # registers, static shared memory and spills of every kernel (-Xptxas -v)
    res = build.kernel_resources()
    for k in ("cm_encode_kernel", "cm_decode_kernel", "cm_encode_resume_kernel",
              "cm_decode_resume_kernel", "crc_lane_kernel", "lzp_encode_kernel",
              "lzp_decode_kernel", "chain_windows_kernel", "range_pass_kernel"):
        _require(k in res, f"no -Xptxas -v lines for {k}")
    out = {"phase": "build", "card": card, "kernel_dir": build.KERNEL_DIR,
           "kernels_s": round(t_kernels, 3), "host_s": round(t_host, 3), "resources": res}
    emit(out)
    return out


def phase_latency(card: str) -> dict:
    """The round trip of a dependent load on the card: one thread chases
    a random single cycle through an 8 MiB table (L2-resident, as the
    LZP kernels' tables: 1 MiB a row, 8 rows) and a 256 MiB one (mostly
    device memory), past L1; CUDA events around each chase.  And the
    cycles of one warp's dependent __match_any_sync."""
    import ctypes

    import torch

    lib = ctypes.CDLL(LATENCY_SO)
    lib.sm_chase.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p,
                             ctypes.c_void_p]
    out = {"phase": "latency", "card": card}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for name, mib, steps in (("l2", 8, 200_000), ("hbm", 256, 50_000)):
        n = mib * MiB // 4
        perm = torch.randperm(n, device="cuda", generator=gen)
        nxt = torch.empty(n, dtype=torch.int64, device="cuda")
        nxt[perm] = perm.roll(-1)  # one cycle through every entry
        nxt = nxt.to(torch.int32)
        del perm
        res = torch.zeros(2, dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        int(nxt.sum())  # brings the table into L2 as far as it fits
        _require(lib.sm_chase(nxt.data_ptr(), 1000, 0, res.data_ptr(), stream) == 0,
                 "sm_chase launch failed")
        _, ms = _timed(lambda: lib.sm_chase(nxt.data_ptr(), steps, 0, res.data_ptr(), stream))
        cycles = res.cpu().tolist()[0]
        out[name] = {"table_mib": mib, "steps": steps, "ns": ms * 1e6 / steps,
                     "cycles": cycles / steps}
        del nxt
    out["sm_clock_mhz"] = out["l2"]["cycles"] / out["l2"]["ns"] * 1e3
    # a warp's dependent __match_any_sync, 32 distinct values and 32 equal
    lib.sm_match_any.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p]
    res = torch.zeros(3, dtype=torch.int64, device="cuda")
    for seed in (1, 2):  # the first run warms up
        _require(lib.sm_match_any(res.data_ptr(), seed, stream) == 0, "sm_match_any launch failed")
    reps = lib.sm_latency_reps()
    cyc = res.cpu().tolist()
    out["match_any_cycles"] = {"distinct": cyc[0] / reps, "equal": cyc[1] / reps}
    # the range coder's bit step alone, P2's dependent chain: its bound
    lib.sm_coder_chain.argtypes = [ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p,
                                   ctypes.c_void_p]
    steps = CODER_CHAIN_STEPS
    for seed in (3, 4):  # the first run warms up
        rc, ms = _timed(lambda s=seed: lib.sm_coder_chain(steps, s, res.data_ptr(), stream))
        _require(rc == 0, "sm_coder_chain launch failed")
    out["coder_chain"] = {"steps": steps, "ns": ms * 1e6 / steps,
                          "cycles": res.cpu().tolist()[0] / steps}
    emit(out)
    return out


def phase_parity(card: str) -> dict:
    """K1/K2 against the plain versions on the same rows, byte for byte."""
    import torch
    from bzip3_tpu_torch.ops.device import cm, cm_cuda

    rng = np.random.default_rng(11)
    n = 4096
    runs = np.repeat(rng.integers(0, 4, 256, dtype=np.uint8),
                     rng.integers(1, 40, 256))[:n].tobytes()
    rows = [
        rng.integers(0, 256, 2000, dtype=np.uint8).tobytes(),  # random
        corpus(n, seed=3),                                    # text-like
        runs,                                                 # runs
        b"\x00" * n,                                          # all-zero
        b"\xff" * 130,
        b"Q",                                                 # 1 byte
        b"",                                                  # empty
        # a confident model meets a surprise: multi-byte renorms
        bytes(2048) + rng.integers(0, 256, 2048, dtype=np.uint8).tobytes(),
        b"ab" * 1000 + b"a" * 1000,                           # run flag on and off
        rng.integers(0, 256, n, dtype=np.uint8).tobytes(),  # payload over the cap below
    ]
    k = len(rows)
    data, lens = _pad(rows, n)
    d_cpu, l_cpu = torch.from_numpy(data), torch.from_numpy(lens)
    d_gpu, l_gpu = d_cpu.cuda(), l_cpu.cuda()
    launches = dict(cm_cuda.LAUNCHES)

    # K1 at the default width, against the plain encoder.
    t0 = time.perf_counter()
    p_out, p_lens = cm.cm_encode_batch(d_cpu, l_cpu)
    enc_plain_ms = (time.perf_counter() - t0) * 1e3
    k_out, k_lens = cm_cuda.cm_encode(d_gpu, l_gpu)
    k_out, k_lens = k_out.cpu().numpy(), k_lens.cpu().numpy()
    p_out, p_lens = p_out.numpy(), p_lens.numpy()
    _require((k_lens == p_lens).all(), (k_lens, p_lens))
    enc_err = max(_row_diff(k_out[i, : p_lens[i]], p_out[i, : p_lens[i]]) for i in range(k))
    _require(enc_err == 0, "K1 differs from the plain encoder")

    # K1 with an output cap that the last row's payload exceeds: the
    # true length is reported and the bytes under the cap are exact.
    cap = 3072
    c_out, c_lens = cm_cuda.cm_encode(d_gpu, l_gpu, cap)
    c_out, c_lens = c_out.cpu().numpy(), c_lens.cpu().numpy()
    _require((c_lens == p_lens).all() and (c_lens > cap).tolist() == [False] * (k - 1) + [True],
             f"capped K1 lengths {c_lens.tolist()}")
    for i in range(k):
        m = min(int(p_lens[i]), cap)
        _require(_row_diff(c_out[i, :m], p_out[i, :m]) == 0, f"capped row {i}")

    # K2 on the plain payloads, one cut in half (stream exhaustion).
    pays = [p_out[i, : p_lens[i]].tobytes() for i in range(k)]
    pays[1] = pays[1][: len(pays[1]) // 2]
    pdata, plens = _pad(pays, int(p_lens.max()))
    pd_cpu, pl_cpu = torch.from_numpy(pdata), torch.from_numpy(plens)
    t0 = time.perf_counter()
    p_dec = cm.cm_decode_batch(pd_cpu, pl_cpu, l_cpu, n).numpy()
    dec_plain_ms = (time.perf_counter() - t0) * 1e3
    pd_gpu, pl_gpu = pd_cpu.cuda(), pl_cpu.cuda()
    k_dec = cm_cuda.cm_decode(pd_gpu, pl_gpu, l_gpu, n).cpu().numpy()
    dec_err = max(_row_diff(k_dec[i, : lens[i]], p_dec[i, : lens[i]]) for i in range(k))
    _require(dec_err == 0, "K2 differs from the plain decoder")
    for i in range(k):
        if i != 1:
            _require(k_dec[i, : lens[i]].tobytes() == rows[i], f"row {i} round trip")

    # Kernel times on these rows (plain times above are one CPU call).
    enc_ms = _cuda_ms(lambda: cm_cuda.cm_encode(d_gpu, l_gpu), 5)
    dec_ms = _cuda_ms(lambda: cm_cuda.cm_decode(pd_gpu, pl_gpu, l_gpu, n), 5)

    # K2(K1(x)) on two 1 MiB rows; one row per CTA, so the launch time
    # over 8 Mi bit steps is the per-step latency of one thread.
    big = [corpus(MiB, seed=5), rng.integers(0, 256, MiB, dtype=np.uint8).tobytes()]
    bdata, blens = _pad(big, MiB)
    bd, bl = torch.from_numpy(bdata).cuda(), torch.from_numpy(blens).cuda()
    e_out, e_lens = cm_cuda.cm_encode(bd, bl)
    big_enc_ms = _cuda_ms(lambda: cm_cuda.cm_encode(bd, bl), 2)
    back = cm_cuda.cm_decode(e_out, e_lens, bl, MiB)
    big_dec_ms = _cuda_ms(lambda: cm_cuda.cm_decode(e_out, e_lens, bl, MiB), 2)
    back = back.cpu().numpy()
    for i in range(2):
        _require(back[i].tobytes() == big[i], f"1 MiB row {i} round trip")
    torch.cuda.synchronize()
    steps = 8 * MiB
    out = {
        "phase": "parity", "card": card, "rows": k, "width": n, "tolerance": 0,
        "k1": {"max_abs_err": enc_err, "ms": enc_ms, "plain_ms": enc_plain_ms,
               "plain_device": "cpu", "payload_lens": p_lens.tolist(),
               "capped_lens": c_lens.tolist(), "cap": cap},
        "k2": {"max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain_ms,
               "plain_device": "cpu"},
        "k2_k1_1MiB": {"rows": 2, "round_trip": True,
                       "payload_lens": e_lens.cpu().tolist(),
                       "k1_ms": big_enc_ms, "k2_ms": big_dec_ms,
                       "k1_ns_per_bit": big_enc_ms * 1e6 / steps,
                       "k2_ns_per_bit": big_dec_ms * 1e6 / steps},
        "parity_launches": {k: cm_cuda.LAUNCHES[k] - launches[k] for k in launches},
    }
    emit(out)
    return out


def phase_golden(card: str) -> None:
    """Reference-made streams decode on the card and re-encode exactly."""
    from bzip3_tpu_torch import compress_file, decompress_file
    from bzip3_tpu_torch.engines import DeviceEngine

    eng = DeviceEngine("cuda")
    res = {}
    for name in GOLDEN:
        with open(os.path.join(ROOT, "tests", "data", name), "rb") as f:
            golden = f.read()
        plain = io.BytesIO()
        decompress_file(io.BytesIO(golden), plain, engine=eng, batch_size=8)
        block_size = int.from_bytes(golden[5:9], "little")
        again = io.BytesIO()
        compress_file(io.BytesIO(plain.getvalue()), again, block_size, engine=eng,
                      batch_size=8, feof_block=False)
        _require(again.getvalue() == golden, f"{name}: re-encode differs")
        res[name] = {"bytes": len(plain.getvalue()), "bz3_bytes": len(golden),
                     "block_size": block_size, "identical": True}
    emit({"phase": "golden", "card": card, "files": res})


def _round_trip(card: str, phase: str, data: bytes, bs: int, blocks: int, engine=None,
                **switches):
    """``blocks`` x ``bs`` through the stream API on ``engine``, by default
    a profiled device engine with the given pipeline switches: (engine,
    compressed stream, result line with throughput, launches, stage times
    and peak memory)."""
    import torch
    from bzip3_tpu_torch import compress_file, decompress_file
    from bzip3_tpu_torch.engines import DeviceEngine

    eng = engine or DeviceEngine("cuda", profile=True, **switches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    comp = io.BytesIO()
    compress_file(io.BytesIO(data), comp, bs, engine=eng, batch_size=blocks)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_launches = launch_counts()
    t0 = time.perf_counter()
    back = io.BytesIO()
    decompress_file(io.BytesIO(comp.getvalue()), back, engine=eng, batch_size=blocks)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    _require(back.getvalue() == data, f"{phase} round trip differs")
    _require(eng.reencoded_rows == 0, eng.reencoded_rows)
    out = {
        "phase": phase, "card": card, "block_size": bs, "blocks": blocks,
        "input_bytes": len(data), "compressed_bytes": len(comp.getvalue()),
        "ratio": len(comp.getvalue()) / len(data),
        "encode_s": enc_s, "decode_s": dec_s,
        "encode_mib_s": len(data) / MiB / enc_s,
        "decode_mib_s": len(data) / MiB / dec_s,
        "launches": launch_counts(), "encode_launches": enc_launches,
        "reencoded_rows": eng.reencoded_rows,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "stages_s": {k: round(v, 6) for k, v in eng.timer.totals.items()},
        "stage_calls": dict(eng.timer.counts),
    }
    return eng, comp.getvalue(), out


def _payloads(stream: bytes, bs: int) -> list[tuple]:
    """(header, CM payload) of each block of a .bz3 stream."""
    from bzip3_tpu_torch.container.stream import iter_chunks
    from bzip3_tpu_torch.models.block_codec import parse_block_header

    out = []
    for _, _, block in iter_chunks(io.BytesIO(stream[9:]), bs):
        hdr = parse_block_header(block)
        out.append((hdr, block[hdr.header_size() :]))
    return out


def phase_main(card: str, data: bytes, bs: int, blocks: int) -> tuple[dict, bytes]:
    """The main path at full width: ``blocks`` x ``bs`` through the
    stream API on the card.  (result line, compressed stream)"""
    _, stream, out = _round_trip(card, "main", data, bs, blocks)
    launches = out["launches"]
    _require({k for k, v in launches.items() if v} == set(DEFAULT_PATH), launches)
    emit(out)
    return out, stream


def _timed(fn):
    """(fn(), milliseconds on the card) for one call."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    res = fn()
    t1.record()
    torch.cuda.synchronize()
    return res, t0.elapsed_time(t1)


class _LaunchTimes:
    """CUDA-event times of the launches made through the named C entry
    points of the kernel wrappers (``cm_cuda``, ``crc32_cuda``,
    ``lzp_cuda``, ``cm_parallel_cuda``) while active: two events on the
    launching stream around each launch, so a main path's own launches
    are timed as they run, with no second run and no synchronise.  Each
    launch's arguments are kept beside its events (``launches``)."""

    def __init__(self, *names: str):
        self.events = {n: [] for n in names}

    def __enter__(self):
        import torch

        plain = _wrappers()[0].entry

        def entry(name, *args, **kw):
            fn = plain(name, *args, **kw)
            if name not in self.events:
                return fn

            def timed(*a):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                rc = fn(*a)
                t1.record()
                self.events[name].append((t0, t1, a))
                return rc

            return timed

        self._restore = plain
        for mod in _wrappers():
            mod.entry = entry
        return self

    def __exit__(self, *exc) -> None:
        for mod in _wrappers():
            mod.entry = self._restore

    def ms(self, name: str) -> tuple[float, int]:
        """(summed milliseconds, launches) of entry point ``name``."""
        import torch

        torch.cuda.synchronize()
        ev = self.events[name]
        return sum(t0.elapsed_time(t1) for t0, t1, _ in ev), len(ev)

    def launches(self, name: str) -> list[tuple[float, tuple]]:
        """(milliseconds, C arguments) of each launch through ``name``."""
        import torch

        torch.cuda.synchronize()
        return [(t0.elapsed_time(t1), a) for t0, t1, a in self.events[name]]


def _decode_prefix_err(kernel_out: np.ndarray, payload, plens, heads: list[int],
                       prefix: int) -> tuple[int, float]:
    """(max abs error, plain ms) of a decoder's first heads[k] <= ``prefix``
    symbols of each row k of ``kernel_out`` against the plain decoder on
    CPU copies of the same payloads.  A symbol is 8 binary decisions of at most 12
    bits each (the least probability is 1/4096), so ``prefix`` symbols
    read at most 12 * prefix + 4 payload bytes: the plain decoder gets
    each payload's first 16 * prefix bytes."""
    import torch
    from bzip3_tpu_torch.ops.device import cm

    cut = 16 * prefix
    olens = torch.tensor(heads, dtype=torch.int32)
    t0 = time.perf_counter()
    want = cm.cm_decode_batch(payload[:, :cut].cpu().contiguous(),
                              plens.cpu().clamp(max=cut), olens, prefix).numpy()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(_row_diff(kernel_out[k, :h], want[k, :h]) for k, h in enumerate(heads))
    return err, plain_ms


def phase_main_shapes(card: str, data: bytes, bs: int, blocks: int,
                      prefix: int = 2048) -> dict:
    """K1 and K2 at the main path's shapes, on its inputs: the blocks'
    post-prepass, post-BWT rows.  K2(K1(u)) == u in full on the card,
    and each kernel against its plain version on every row's first
    ``prefix`` symbols.  The coder is causal: the bytes a row emits
    while coding its first P symbols do not depend on what follows, the
    plain encode of those P symbols adds only its 4 flush bytes, and a
    decoder of P symbols reads no payload past them."""
    import torch
    from bzip3_tpu_torch.ops.device import cm, cm_cuda
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch
    from bzip3_tpu_torch.pipeline import host_prepass

    rows = [host_prepass(data[i * bs : (i + 1) * bs])[3] for i in range(blocks)]
    width = -(-max(map(len, rows)) // 256) * 256
    arr, lens = _pad(rows, width)
    l_gpu = torch.from_numpy(lens).cuda()
    u, _ = bwt_forward_batch(torch.from_numpy(arr).cuda(), l_gpu)
    (payload, plens), k1_ms = _timed(lambda: cm_cuda.cm_encode(u, l_gpu))
    _require(int(plens.max()) <= payload.shape[1], "a main-path payload overflowed")
    dec, k2_ms = _timed(lambda: cm_cuda.cm_decode(payload, plens, l_gpu, width))
    inside = torch.arange(width, device=u.device)[None, :] < l_gpu[:, None]
    _require(torch.equal(torch.where(inside, dec, 0), torch.where(inside, u, 0)),
             "K2(K1(u)) differs at the main path's shapes")

    lp = torch.from_numpy(lens).clamp(max=prefix)
    u_head = u[:, :prefix].cpu().contiguous()
    t0 = time.perf_counter()
    p_out, p_lens = cm.cm_encode_batch(u_head, lp)
    enc_plain_ms = (time.perf_counter() - t0) * 1e3
    p_out, p_lens = p_out.numpy(), p_lens.numpy()
    m = int(p_lens.max())
    k_head = payload[:, :m].cpu().numpy()
    enc_err = max(_row_diff(k_head[i, : p_lens[i] - 4], p_out[i, : p_lens[i] - 4])
                  for i in range(blocks))
    _require(enc_err == 0, "K1 differs from the plain encoder at the main path's shapes")
    t0 = time.perf_counter()
    p_dec = cm.cm_decode_batch(
        payload[:, : m + 8].cpu().contiguous(), plens.cpu().clamp(max=m + 8), lp, prefix
    ).numpy()
    dec_plain_ms = (time.perf_counter() - t0) * 1e3
    k_dec = dec[:, :prefix].cpu().numpy()
    dec_err = max(_row_diff(k_dec[i, : lp[i]], p_dec[i, : lp[i]]) for i in range(blocks))
    _require(dec_err == 0, "K2 differs from the plain decoder at the main path's shapes")
    out = {
        "phase": "main_shapes", "card": card, "shape": [blocks, width],
        "row_lens": lens.tolist(), "payload_lens": plens.cpu().tolist(),
        "k1_ms": k1_ms, "k2_ms": k2_ms, "round_trip": True, "prefix": prefix,
        "k1_ns_per_bit_step": k1_ms * 1e6 / (8 * int(lens.max())),
        "k2_ns_per_bit_step": k2_ms * 1e6 / (8 * int(lens.max())),
        "k1_prefix_max_abs_err": enc_err, "k2_prefix_max_abs_err": dec_err,
        "k1_plain_prefix_ms": enc_plain_ms, "k2_plain_prefix_ms": dec_plain_ms,
        "plain_device": "cpu",
    }
    emit(out)
    return out


def _lzp_cases() -> list[bytes]:
    """The kinds of row of tests/test_lzp_pallas.py, each <= 4 KiB: the
    encoder's heur rejection, word + 0..3 extension, base-254 lengths,
    0xF2 escapes with and without a live prediction, out_cap; then every
    row of ``lzp_hazards()``."""
    rng = np.random.default_rng(42)
    text = (b"the quick brown fox jumps over the lazy dog. " * 40)[:1600]
    return [
        text,
        text[:200] + b"X" * 30 + text[:200] + b"Y" * 30 + text[:500],  # long matches
        b"A" * 700 + b"B" * 11 + b"A" * 700,  # runs past 254
        bytes([0xF2]) * 90 + text[:300] + bytes([0xF2, 0xF2, 1, 2, 0xF2]),  # escapes
        rng.integers(0, 256, 1500, dtype=np.uint8).tobytes(),  # random
        b"abcdefgh" * 200,  # periodic
        b"".join(b"CTXT" + bytes([i]) * 9 for i in range(40)),  # heur
        b"tiny",
        (text * 3)[:4096],  # multi-254 lengths
        b"",
        b"Z" * 71,
        b"Z" * 72,
    ] + [r for rows in lzp_hazards().values() for r in rows]


def _lzp_hash(ctx: np.ndarray) -> np.ndarray:
    return ((ctx >> 15) ^ ctx ^ (ctx >> 3)) & ((1 << 18) - 1)


def lzp_hazards() -> dict[str, list[bytes]]:
    """Rows of at most 4 KiB for the hazards of K5/K6's windows of 32
    positions (one warp a row), by hazard: equal hashes inside a window
    (periods under 32, and two contexts of one hash a few bytes apart),
    a match that starts at each lane offset, an extension that stops at
    scan_end, a heur rejection with a match a few positions after it,
    0xF2 bytes in every lane with and without a live prediction, out_cap
    reached at every lane offset and near its edge, and copies at distances
    1..33 (which the decoder also cuts at max_out inside the copy)."""
    rng = np.random.default_rng(43)

    def rnd(k: int, alphabet=None) -> bytes:
        if alphabet is None:
            return rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        return bytes(rng.choice(np.frombuffer(alphabet, np.uint8), k))

    # pairs of different contexts with one hash
    ctx = rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64)
    order = np.argsort(_lzp_hash(ctx), kind="stable")
    hs = _lzp_hash(ctx)[order]
    dup = np.nonzero((hs[1:] == hs[:-1]) & (ctx[order][1:] != ctx[order][:-1]))[0][:6]
    pairs = [(int(ctx[order][j]).to_bytes(4, "big"), int(ctx[order][j + 1]).to_bytes(4, "big"))
             for j in dup]
    units = [a + rnd(6) + b + rnd(40) for a, b in pairs]
    collide = b"".join(units) + rnd(30) + b"".join(units)

    def at_lane(k: int) -> bytes:
        c, x = rnd(4), rnd(60)
        head = rnd(6) + c + x
        # the second copy's first position is 4 + 32 * 4 + k: lane k of a window
        return head + rnd(4 + 32 * 4 + k - 4 - len(head)) + c + x + rnd(80)

    def heur(shift: int) -> bytes:
        c, d = rnd(4), bytearray(rnd(100))
        d2 = bytearray(d)
        d2[5] ^= 0x55  # the candidate passes, the extension stops at 4 bytes
        return rnd(10 + shift) + c + bytes(d) + rnd(20) + c + bytes(d2) + rnd(40)

    tok = bytes([0xF2])

    def escapes(k: int) -> bytes:
        # a 44-byte match saves 42 bytes, then k units of an escaped 0xF2
        # each add one: the output reaches out_cap near k = 36
        c, x = rnd(4), rnd(44)
        units = b"".join(rnd(1, b"\x05\x06") + b"\x01\x02\x03" + tok for _ in range(k))
        return rnd(8) + c + x + rnd(20) + c + x + rnd(80) + units

    return {
        "equal_hashes": [(rnd(p) * (600 // p + 1))[:600] for p in (1, 2, 3, 5, 16, 31)]
        + [collide],
        "lane_offsets": [at_lane(k) for k in range(32)],
        "scan_end": [b"Z" * n for n in (73, 74, 75, 76)]
        + [(x * 4)[:n] for n, x in ((100, rnd(45)), (101, rnd(45)), (102, rnd(45)),
                                   (103, rnd(45)), (1001, rnd(300)))],
        "heur_then_match": [heur(s) for s in range(8)],
        "token_lanes": [tok * 300, (tok + rnd(1)) * 200,
                        b"".join(rnd(1, b"\x05\x06") + b"\x01\x02\x03" + tok for _ in range(120)),
                        rnd(400, tok + b"\x01")],
        "out_cap": [rnd(n) for n in range(72, 105)] + [escapes(k) for k in range(28, 46)],
        "copy_distances": [(rnd(d) * (400 // d + 1))[:400] for d in range(1, 34)],
    }


def lzp_streams(encoded: list[bytes]) -> list[bytes]:
    """Decoder inputs beside the encoder's own streams: each stream cut
    right after each of its first 0xF2 bytes (a truncated token where the
    prediction is live), a long match's length cut inside its run of
    254s, and arbitrary streams of 0xF2, 254, 255 and two other bytes."""
    rng = np.random.default_rng(44)
    out = []
    for e in encoded:
        cuts = [j + 1 for j in range(4, len(e)) if e[j] == 0xF2][:3]
        out += [e[:c] for c in cuts]
        k = e.find(bytes([0xF2, 254]), 4)
        if k >= 0:
            out.append(e[: k + 2])
    alphabet = np.array([0xF2, 254, 255, 0x61, 0x62], np.uint8)
    out += [bytes(rng.choice(alphabet, n)) for n in (4, 40, 300, 1000)]
    return out


def phase_parity_prepass(card: str) -> dict:
    """K4, K5 and K6 against their plain versions on the same rows, byte
    for byte (K5/K6 on every window hazard too); K4's CRCs against the
    host C++; the time a byte of each on one row (K4: one CTA on a 4 MiB
    lane; K5/K6: one warp over windows of 32 literals)."""
    import torch
    from bzip3_tpu_torch.ops import host
    from bzip3_tpu_torch.ops.device import crc32, crc32_cuda, lzp, lzp_cuda

    rows = _lzp_cases()
    n = max(map(len, rows))
    data, lens = _pad(rows, n)
    d_cpu, l_cpu = torch.from_numpy(data), torch.from_numpy(lens)
    d_gpu, l_gpu = d_cpu.cuda(), l_cpu.cuda()
    before = launch_counts()

    # K4 on the first 12 rows: lane states at the lane count crc32_batch
    # gives the kernel (one lane a row here), at 128 lanes (32-byte lanes)
    # and at 7 (lanes that start and end inside 16-byte units), then
    # whole CRCs.
    c_cpu, cl_cpu, c_gpu, cl_gpu = d_cpu[:12], l_cpu[:12], d_gpu[:12], l_gpu[:12]
    k4_lanes = crc32_cuda.lanes_for(c_gpu)
    k4_err, k4_plain_ms = 0, 0.0
    for lanes in (k4_lanes, 128, 7):
        t0 = time.perf_counter()
        want = crc32.crc_lane_scan(c_cpu, cl_cpu, lanes)
        k4_plain_ms += (time.perf_counter() - t0) * 1e3
        got = crc32_cuda.crc_lane_scan(c_gpu, cl_gpu, lanes).cpu()
        _require(got.shape == want.shape, (got.shape, want.shape))
        k4_err = max(k4_err, int((got - want).abs().max()))
    _require(k4_err == 0, "K4 differs from the plain lane scan")
    crcs = crc32_cuda.crc32_batch(c_gpu, cl_gpu).cpu().tolist()
    _require(crcs == [host.crc32(r) for r in rows[:12]], "K4 CRCs differ from the host C++")
    k4_ms = _cuda_ms(lambda: crc32_cuda.crc_lane_scan(c_gpu, cl_gpu, k4_lanes), 5, queue=True)

    # K5 against the plain encoder: the smoke's LZP rows and every window
    # hazard (lzp_hazards).
    t0 = time.perf_counter()
    p_out, p_lens = lzp.lzp_encode_batch(d_cpu, l_cpu)
    k5_plain_ms = (time.perf_counter() - t0) * 1e3
    k_out, k_lens = lzp_cuda.lzp_encode(d_gpu, l_gpu)
    k_out, k_lens = k_out.cpu().numpy(), k_lens.cpu().numpy()
    p_out, p_lens = p_out.numpy(), p_lens.numpy()
    _require((k_lens == p_lens).all(), (k_lens.tolist(), p_lens.tolist()))
    _require(int((p_lens > 0).sum()) >= len(rows) // 2, f"LZP applied to too few rows: {p_lens.tolist()}")
    k5_err = max(_row_diff(k_out[i, : max(0, p_lens[i])], p_out[i, : max(0, p_lens[i])])
                 for i in range(len(rows)))
    _require(k5_err == 0, "K5 differs from the plain encoder")
    k5_ms = _cuda_ms(lambda: lzp_cuda.lzp_encode(d_gpu, l_gpu), 3)

    # K6 on the encoded rows, streams cut inside tokens, arbitrary streams
    # (lzp_streams) and rows of length 0 and 3; at a max_out past every
    # row and at two that cut rows inside their copies.
    enc = [p_out[i, : p_lens[i]].tobytes() for i in range(len(rows)) if p_lens[i] > 0]
    enc += lzp_streams(enc) + [b"", b"abc"]
    e_arr, e_lens = _pad(enc, max(map(len, enc)))
    e_cpu, el_cpu = torch.from_numpy(e_arr), torch.from_numpy(e_lens)
    e_gpu, el_gpu = e_cpu.cuda(), el_cpu.cuda()
    k6_err, k6_plain_ms, cut_lens = 0, 0.0, {}
    for max_out in (n + 64, 131, 37):
        t0 = time.perf_counter()
        q_out, q_lens = lzp.lzp_decode_batch(e_cpu, el_cpu, max_out)
        k6_plain_ms += (time.perf_counter() - t0) * 1e3
        g_out, g_lens = lzp_cuda.lzp_decode(e_gpu, el_gpu, max_out)
        g_out, g_lens = g_out.cpu().numpy(), g_lens.cpu().numpy()
        q_out, q_lens = q_out.numpy(), q_lens.numpy()
        _require((g_lens == q_lens).all(), (max_out, g_lens.tolist(), q_lens.tolist()))
        _require(q_lens[-2:].tolist() == [-1, -1] and (q_lens < 0).sum() > 2, q_lens.tolist())
        _require(max_out > n or int(q_lens.max()) == max_out, f"no row was cut at {max_out}")
        k6_err = max(k6_err, max(_row_diff(g_out[i, : max(0, q_lens[i])],
                                           q_out[i, : max(0, q_lens[i])]) for i in range(len(enc))))
        cut_lens[max_out] = q_lens.tolist()
    _require(k6_err == 0, "K6 differs from the plain decoder")
    k6_ms = _cuda_ms(lambda: lzp_cuda.lzp_decode(e_gpu, el_gpu, n + 64), 3)
    parity_launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}

    # The time a byte of one CTA alone on the card: K4 on one 4 MiB lane
    # (one CTA); K5 and K6 (one warp) on 1 MiB of random bytes without
    # 0xF2, all literals (K5 stops at out_cap after MiB - 8 of them, K6
    # decodes all MiB).
    rng = np.random.default_rng(13)
    lane = torch.from_numpy(rng.integers(0, 256, (1, 4 * MiB), dtype=np.uint8)).cuda()
    lane_len = torch.tensor([4 * MiB], dtype=torch.int32).cuda()
    k4_state = int(crc32_cuda.crc_lane_scan(lane, lane_len, 1)[0, 0])
    _require(crc32.crc32_from_lanes(torch.tensor([[k4_state]]), 4 * MiB, lane_len.cpu()).item()
             == host.crc32(lane.cpu().numpy().tobytes()), "K4 on one 4 MiB lane")
    k4_step_ns = (_cuda_ms(lambda: crc32_cuda.crc_lane_scan(lane, lane_len, 1), 5, queue=True)
                  * 1e6 / (4 * MiB))
    lit = rng.integers(0, 255, (1, MiB), dtype=np.uint8)
    lit[lit == 0xF2] = 0xF1
    big = torch.from_numpy(lit).cuda()
    big_len = torch.tensor([MiB], dtype=torch.int32).cuda()
    _require(int(lzp_cuda.lzp_encode(big, big_len)[1][0]) == -1, "1 MiB literal row: LZP applied")
    k5_step_ns = _cuda_ms(lambda: lzp_cuda.lzp_encode(big, big_len), 2) * 1e6 / (MiB - 8)
    back, back_lens = lzp_cuda.lzp_decode(big, big_len, MiB)
    _require(int(back_lens[0]) == MiB and torch.equal(back, big), "1 MiB literal row: K6")
    k6_step_ns = _cuda_ms(lambda: lzp_cuda.lzp_decode(big, big_len, MiB), 2) * 1e6 / MiB
    out = {
        "phase": "parity_prepass", "card": card, "rows": len(rows), "width": n, "tolerance": 0,
        "k4": {"max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms, "shape": [12, n],
               "lanes": [k4_lanes, 128, 7], "plain_device": "cpu", "crcs_equal_host": True,
               "step_ns": k4_step_ns},
        "k5": {"max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms, "shape": [len(rows), n],
               "plain_device": "cpu", "out_lens": p_lens.tolist(), "step_ns": k5_step_ns},
        "k6": {"max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms,
               "shape": list(e_arr.shape), "plain_device": "cpu", "out_lens": cut_lens,
               "step_ns": k6_step_ns},
        "hazards": {k: len(v) for k, v in lzp_hazards().items()},
        "parity_launches": parity_launches,
    }
    emit(out)
    return out


def log_corpus(size: int, seed: int) -> bytes:
    """Seeded web-server access log lines (combined log format): paths,
    referers and user agents repeat, each 40 bytes or more, so LZP
    finds long matches."""
    rng = np.random.default_rng(seed)
    agents = [
        b"Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 (KHTML, like Gecko) "
        b"Chrome/%d.0.%d.%d Safari/537.36" % (100 + i, 4000 + 37 * i, 60 + i) for i in range(12)
    ] + [
        b"Mozilla/5.0 (X11; Linux x86_64; rv:%d.0) Gecko/20100101 Firefox/%d.0" % (i, i)
        for i in range(90, 100)
    ] + [b"curl/7.%d.0 (x86_64-pc-linux-gnu) libcurl/7.%d.0 OpenSSL/3.0.2" % (i, i)
         for i in range(60, 68)]
    words = [bytes(rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8),
                              int(rng.integers(3, 10)))) for _ in range(300)]
    paths = [b"/" + b"/".join(words[j] for j in rng.integers(0, 300, int(rng.integers(2, 6))))
             + (b".html", b".png", b".js", b"/")[i % 4] for i in range(400)]
    lines = []
    total = 0
    n = size // 120 + 1000
    ips = rng.integers(1, 255, (n, 4))
    pi = rng.zipf(1.3, n) % len(paths)
    ai = rng.integers(0, len(agents), n)
    ri = rng.zipf(1.5, n) % len(paths)
    st = rng.choice([200, 200, 200, 304, 404, 500], n)
    sz = rng.integers(100, 90000, n)
    sec = np.cumsum(rng.integers(0, 3, n))
    for k in range(n):
        s_ = int(sec[k])
        line = b'%d.%d.%d.%d - - [16/Oct/2026:%02d:%02d:%02d +0000] "GET %s HTTP/1.1" %d %d ' \
            b'"https://example.org%s" "%s"\n' % (
                *ips[k], (s_ // 3600) % 24, (s_ // 60) % 60, s_ % 60, paths[pi[k]],
                st[k], sz[k], paths[ri[k]], agents[ai[k]])
        lines.append(line)
        total += len(line)
        if total >= size:
            break
    out = b"".join(lines)[:size]
    _require(len(out) == size, (len(out), size))
    return out


def sparse_block(size: int, seed: int) -> bytes:
    """Short random records between runs of zero bytes (a sparse file or
    a zero-filled table), where RLE is kept."""
    rng = np.random.default_rng(seed)
    out = np.zeros(size, np.uint8)
    pos = 0
    while pos < size:
        pos += int(rng.integers(100, 2000))
        rec = int(rng.integers(8, 64))
        out[pos : pos + rec] = rng.integers(1, 256, min(rec, max(0, size - pos)), dtype=np.uint8)
        pos += rec
    return out.tobytes()


def phase_main_prepass(card: str, data: bytes, bs: int, blocks: int) -> tuple[dict, bytes]:
    """The device prepass chain at full width: ``blocks`` x ``bs``
    through the stream API on the card, against the default path.
    (result line, compressed stream)"""
    from bzip3_tpu_torch import compress_file
    from bzip3_tpu_torch.engines import DeviceEngine

    _, comp, out = _round_trip(card, "main_prepass", data, bs, blocks, device_prepass=True)
    default = io.BytesIO()
    compress_file(io.BytesIO(data), default, bs, engine=DeviceEngine("cuda", device_prepass=False),
                  batch_size=blocks)
    _require(comp == default.getvalue(), "device prepass stream differs from the default path's")
    models = [hdr.model for hdr, _ in _payloads(comp, bs)]
    _require(any(m & 2 for m in models) and any(m & 4 for m in models), f"models {models}")
    launches = out["launches"]
    _require({k for k, v in launches.items() if v} == set(PREPASS_PATH),
             f"launches off the chain's kernels: {launches}")
    out.update({"models": models, "identical_to_default_path": True,
                "crc_stages_s": {k: out["stages_s"][k] for k in ("encode/crc", "decode/crc_verify")}})
    emit(out)
    return out, comp


def phase_prepass_shapes(card: str, data: bytes, bs: int, blocks: int, lat: dict) -> dict:
    """K4, K5 and K6 on the prepass phase's own [blocks, bs] rows, timed
    with CUDA events and checked in full against the host C++: K4's
    CRCs, K5 on the post-RLE rows, K6 back to K5's input.  K5 and K6
    count each row's windows and events (``stats``); beside each
    kernel's bound by bytes, the design's latency bound: the row with
    the most windows, at ``lat``'s L2 round trip for each dependent
    table read (two a K5 window, one a K6 window that reads the table)."""
    import torch
    from bzip3_tpu_torch.ops import host
    from bzip3_tpu_torch.ops.device import crc32, crc32_cuda, lzp_cuda, rle

    raw = [data[i * bs : (i + 1) * bs] for i in range(blocks)]
    arr, lens = _pad(raw, bs)
    orig, orig_lens = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
    k4_lanes = crc32_cuda.lanes_for(orig)
    states = crc32_cuda.crc_lane_scan(orig, orig_lens, k4_lanes)
    crcs = crc32.crc32_from_lanes(states, bs, orig_lens).cpu().tolist()
    _require(crcs == [host.crc32(r) for r in raw], "K4 CRCs differ from the host C++")
    k4_ms = _cuda_ms(lambda: crc32_cuda.crc_lane_scan(orig, orig_lens, k4_lanes), 20, queue=True)
    # the encode/crc stage's work: K4, the lane combine and the pad
    # unwind (tensor code), host clock to a synchronise
    batch_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crc32_cuda.crc32_batch(orig, orig_lens)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)

    r_out, r_lens = rle.rle_encode_batch(orig, orig_lens, bs + 64)
    use_rle = r_lens < orig_lens
    cur = torch.where(use_rle[:, None], r_out[:, :bs], orig)
    cur_lens = torch.where(use_rle, r_lens, orig_lens)
    del r_out
    s5 = torch.zeros((blocks, lzp_cuda.STATS), dtype=torch.int32, device="cuda")
    s6 = torch.zeros_like(s5)
    (l_out, l_lens), k5_ms = _timed(lambda: lzp_cuda.lzp_encode(cur, cur_lens, stats=s5))
    cur_np, cl = cur.cpu().numpy(), cur_lens.cpu().tolist()
    l_np, ll = l_out.cpu().numpy(), l_lens.cpu().tolist()
    for i in range(blocks):
        want = host.lzp_encode(cur_np[i, : cl[i]].tobytes())
        _require(ll[i] == (-1 if want is None else len(want)), f"K5 length, row {i}")
        _require(want is None or l_np[i, : ll[i]].tobytes() == want, f"K5 bytes, row {i}")
    (d_out, d_lens), k6_ms = _timed(
        lambda: lzp_cuda.lzp_decode(l_out, l_lens.clamp(min=0), bs, stats=s6))
    d_np, dl = d_out.cpu().numpy(), d_lens.cpu().tolist()
    for i in range(blocks):
        if ll[i] >= 0:
            _require(dl[i] == cl[i] and (d_np[i, : dl[i]] == cur_np[i, : cl[i]]).all(),
                     f"K6(K5(x)) differs from x, row {i}")
    s5, s6 = s5.cpu().tolist(), s6.cpu().tolist()
    rt = lat["l2"]["ns"]
    k5_lat = max(2 * r[0] for r in s5) * rt * 1e-6
    k6_lat = max(r[2] for i, r in enumerate(s6) if ll[i] >= 0) * rt * 1e-6
    lz_out = [max(0, v) for v in ll]
    dec_out = [cl[i] for i in range(blocks) if ll[i] >= 0]
    k5_bytes = sum(cl) + sum(lz_out) + 8 * blocks
    k6_bytes = sum(lz_out) + sum(dec_out) + 8 * blocks
    k5_steps, k6_steps = max(cl), max(dec_out, default=1)
    out = {
        "phase": "prepass_shapes", "card": card, "shape": [blocks, bs],
        "row_lens": lens.tolist(), "post_rle_lens": cl, "lzp_lens": ll, "crcs_equal_host": True,
        "k4_ms": k4_ms, "lanes": int(states.shape[1]), "seg": crc32.lane_layout(bs, k4_lanes)[1],
        "k4_smem_bytes": crc32_cuda.smem_bytes(), "crc32_batch_ms": batch_ms,
        "k5_ms": k5_ms, "k6_ms": k6_ms, "k5_equal_host": True, "k6_round_trip": True,
        "k5_ns_per_byte_step": k5_ms * 1e6 / k5_steps, "k6_ns_per_byte_step": k6_ms * 1e6 / k6_steps,
        "k5_steps": k5_steps, "k6_steps": k6_steps,
        "k5_stats": {"per_row": s5, "cols": ["windows", "events", "extension_steps", "matches", "us"]},
        "k6_stats": {"per_row": s6, "cols": ["windows", "events", "table_windows", "copy_steps", "us"]},
        "l2_round_trip_ns": rt,
        "k5_bytes": k5_bytes, "k6_bytes": k6_bytes,
        "k5_bytes_bound_ms": k5_bytes / PEAK_BYTES_PER_S * 1e3,
        "k6_bytes_bound_ms": k6_bytes / PEAK_BYTES_PER_S * 1e3,
        "k5_latency_bound_ms": k5_lat, "k6_latency_bound_ms": k6_lat,
    }
    emit(out)
    return out


def _cm_fixture() -> list[bytes]:
    """The 8 rows of tests/test_torch_cm.py (an empty row, a 1-byte row,
    runs, random and text-like bytes, up to 700 bytes)."""
    rng = np.random.default_rng(1234)
    return [
        bytes(rng.integers(97, 123, 300, dtype=np.uint8)),
        bytes(rng.integers(0, 256, 513, dtype=np.uint8)),
        b"abcabcabc" * 40,
        b"\x00" * 200,
        bytes(rng.integers(0, 4, 700, dtype=np.uint8)),
        b"",
        b"Q",
        b"\xff" * 130,
    ]


def phase_parity_resume(card: str) -> dict:
    """K3a, K3b and K3c against their plain versions on CPU copies of the
    same rows, in launches of 256 steps, byte for byte; and against K1
    and K2 on the card.  Rows: tests/test_torch_cm.py's 8 (one ends in
    the first window, one is empty, others end inside later windows) and
    an incompressible 4 KiB row over 16 launches."""
    import torch
    from bzip3_tpu_torch.ops.device import cm, cm_cuda

    n, chunk = 4096, 256
    rng = np.random.default_rng(21)
    rows = _cm_fixture() + [rng.integers(0, 256, n, dtype=np.uint8).tobytes()]
    data, lens = _pad(rows, n)
    d_cpu, l_cpu = torch.from_numpy(data), torch.from_numpy(lens)
    d_gpu, l_gpu = d_cpu.cuda(), l_cpu.cuda()
    before = launch_counts()

    # K3a against the plain resumable encoder, and against K1.
    t0 = time.perf_counter()
    p_out, p_lens = cm.cm_encode_resumable(d_cpu, l_cpu, chunk_steps=chunk)
    k3a_plain_ms = (time.perf_counter() - t0) * 1e3
    p_out, p_lens = p_out.numpy(), p_lens.numpy()
    k_out, k_lens = cm_cuda.cm_encode_resumable(d_gpu, l_gpu, chunk_steps=chunk)
    k_out, k_lens = k_out.cpu().numpy(), k_lens.cpu().numpy()
    one_out, one_lens = (t.cpu().numpy() for t in cm_cuda.cm_encode(d_gpu, l_gpu))
    _require((k_lens == p_lens).all() and (k_lens == one_lens).all(),
             (k_lens.tolist(), p_lens.tolist(), one_lens.tolist()))
    k3a_err = max(_row_diff(k_out[i, : p_lens[i]], p_out[i, : p_lens[i]]) for i in range(len(rows)))
    _require(k3a_err == 0, "K3a differs from the plain resumable encoder")
    _require(all((k_out[i, : p_lens[i]] == one_out[i, : p_lens[i]]).all() for i in range(len(rows))),
             "K3a differs from K1")

    # K3a with a cap under the incompressible row's payload: the true
    # length is reported and the bytes under the cap are exact.
    cap = 3072
    c_out, c_lens = cm_cuda.cm_encode_resumable(d_gpu, l_gpu, cap, chunk_steps=chunk)
    c_out, c_lens = c_out.cpu().numpy(), c_lens.cpu().numpy()
    _require((c_lens == p_lens).all() and int(c_lens[-1]) > cap, f"capped K3a {c_lens.tolist()}")
    for i in range(len(rows)):
        m = min(int(p_lens[i]), cap)
        _require(_row_diff(c_out[i, :m], p_out[i, :m]) == 0, f"capped K3a row {i}")

    # K3b and K3c on the payloads, the incompressible one cut in half: its
    # input runs out in the eighth launch of sixteen.
    pays = [p_out[i, : p_lens[i]].tobytes() for i in range(len(rows))]
    pays[-1] = pays[-1][: len(pays[-1]) // 2]
    pdata, plens = _pad(pays, int(p_lens.max()))
    pd_cpu, pl_cpu = torch.from_numpy(pdata), torch.from_numpy(plens)
    pd_gpu, pl_gpu = pd_cpu.cuda(), pl_cpu.cuda()
    t0 = time.perf_counter()
    p_dec = cm.cm_decode_resumable(pd_cpu, pl_cpu, l_cpu, n, chunk).numpy()
    k3b_plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    p_pieces = list(cm.cm_decode_stream(pd_cpu, pl_cpu, l_cpu, n, chunk))
    k3c_plain_ms = (time.perf_counter() - t0) * 1e3
    k_dec = cm_cuda.cm_decode_resumable(pd_gpu, pl_gpu, l_gpu, n, chunk).cpu().numpy()
    k_pieces = [(s0, p.cpu().numpy())
                for s0, p in cm_cuda.cm_decode_stream(pd_gpu, pl_gpu, l_gpu, n, chunk)]
    two = cm_cuda.cm_decode(pd_gpu, pl_gpu, l_gpu, n).cpu().numpy()
    _require([s0 for s0, _ in k_pieces] == [s0 for s0, _ in p_pieces] == list(range(0, n, chunk)),
             "K3c pieces")
    k3b_err = max(_row_diff(k_dec[i, : lens[i]], p_dec[i, : lens[i]]) for i in range(len(rows)))
    k3c_err = 0
    for (s0, kp), (_, pp) in zip(k_pieces, p_pieces):
        for i in range(len(rows)):
            m = max(0, min(int(lens[i]) - s0, kp.shape[1]))
            k3c_err = max(k3c_err, _row_diff(kp[i, :m], pp[i, :m].numpy()))
            _require((kp[i, :m] == two[i, s0 : s0 + m]).all(), f"K3c differs from K2, row {i}")
    _require(k3b_err == 0, "K3b differs from the plain resumable decoder")
    _require(k3c_err == 0, "K3c differs from the plain stream decoder")
    for i in range(len(rows)):
        _require((k_dec[i, : lens[i]] == two[i, : lens[i]]).all(), f"K3b differs from K2, row {i}")
        if i != len(rows) - 1:
            _require(k_dec[i, : lens[i]].tobytes() == rows[i], f"row {i} round trip")
    k3_ms = {
        "k3a": _cuda_ms(lambda: cm_cuda.cm_encode_resumable(d_gpu, l_gpu, chunk_steps=chunk), 3),
        "k3b": _cuda_ms(
            lambda: cm_cuda.cm_decode_resumable(pd_gpu, pl_gpu, l_gpu, n, chunk), 3),
        "k3c": _cuda_ms(
            lambda: list(cm_cuda.cm_decode_stream(pd_gpu, pl_gpu, l_gpu, n, chunk)), 3),
    }
    plain = {"k3a": k3a_plain_ms, "k3b": k3b_plain_ms, "k3c": k3c_plain_ms}
    errs = {"k3a": k3a_err, "k3b": k3b_err, "k3c": k3c_err}
    out = {
        "phase": "parity_resume", "card": card, "rows": len(rows), "width": n,
        "chunk_steps": chunk, "launches_per_call": n // chunk, "tolerance": 0,
        "payload_lens": p_lens.tolist(), "capped_lens": c_lens.tolist(), "cap": cap,
        "equal_to_k1_k2": True,
        **{k: {"max_abs_err": errs[k], "ms": k3_ms[k], "plain_ms": plain[k],
               "plain_device": "cpu"} for k in plain},
        "parity_launches": {k: v - before[k] for k, v in launch_counts().items() if v != before[k]},
    }
    emit(out)
    return out


def phase_main_b32(card: str, data: bytes, prefix: int = 2048) -> dict:
    """The device path at -b 32: 2 blocks of 32 MiB (text, log lines)
    whose CM rows are past one launch chunk, so K3a and K3b code them in
    two launches of 16 Mi steps, each launch timed as it runs.  Then K1
    in one launch on the same BWT rows must write the payloads of the
    stream, K2 in one launch on those payloads must give back the rows,
    and K3b at the full width, on those payloads, must equal the plain
    decoder on every row's first ``prefix`` symbols."""
    import torch
    from bzip3_tpu_torch.ops.device import cm_cuda
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch
    from bzip3_tpu_torch.pipeline import host_prepass

    bs, blocks = 32 * MiB, 2
    with _LaunchTimes("bz3t_cm_encode_resume", "bz3t_cm_decode_resume") as lt:
        _, comp, out = _round_trip(card, "main_b32", data, bs, blocks)
    launches = out["launches"]
    _require({k for k, v in launches.items() if v} == set(B32_PATH)
             and launches["cm_encode_resume"] == launches["cm_decode_resume"] == 2, launches)
    (k3a_ms, na), (k3b_ms, nb) = lt.ms("bz3t_cm_encode_resume"), lt.ms("bz3t_cm_decode_resume")
    _require(na == nb == 2, f"timed {na} K3a and {nb} K3b launches")

    rows = [host_prepass(data[i * bs : (i + 1) * bs])[3] for i in range(blocks)]
    width = -(-max(map(len, rows)) // 256) * 256
    arr, lens = _pad(rows, width)
    l_gpu = torch.from_numpy(lens).cuda()
    u, idx = bwt_forward_batch(torch.from_numpy(arr).cuda(), l_gpu)
    before = cm_cuda.LAUNCHES["cm_encode"]
    # a launch chunk as wide as the rows: K1 in one launch
    (payload, plens), k1_ms = _timed(lambda: cm_cuda.cm_encode(u, l_gpu, chunk_steps=width))
    _require(cm_cuda.LAUNCHES["cm_encode"] == before + 1, "K1 did not launch")
    pl, idx = plens.cpu().tolist(), idx.cpu().tolist()
    k1_pay = payload.cpu().numpy()
    # (with batch_size 2 the stream ends in an empty block, src/main.c:351-362)
    for j, (hdr, pay) in enumerate(_payloads(comp, bs)[:blocks]):
        _require(hdr.bwt_idx == idx[j] and len(pay) == pl[j]
                 and k1_pay[j, : pl[j]].tobytes() == pay, f"K1 and K3a differ on block {j}")
    # K2 in one launch on those payloads must give back the BWT rows: the
    # rows K3b decoded on the main path, whose round trip was exact
    before = cm_cuda.LAUNCHES["cm_decode"]
    k2_dec, k2_ms = _timed(lambda: cm_cuda.cm_decode(payload, plens, l_gpu, width,
                                                     chunk_steps=width))
    _require(cm_cuda.LAUNCHES["cm_decode"] == before + 1, "K2 did not launch")
    inside = torch.arange(width, device=u.device)[None, :] < l_gpu[:, None]
    _require(torch.equal(torch.where(inside, k2_dec, 0), torch.where(inside, u, 0)),
             "K2 in one launch differs from K3b's output")
    # K3b at the full width (two launches of 16 Mi steps), rows cut to
    # their first symbols, against the plain decoder on the same payloads
    head = l_gpu.clamp(max=prefix)
    hl = head.cpu().tolist()
    dec = cm_cuda.cm_decode_resumable(payload, plens, head, width)[:, :prefix].cpu().numpy()
    k3b_err, k3b_plain_ms = _decode_prefix_err(dec, payload, plens, hl, prefix)
    _require(k3b_err == 0, "K3b differs from the plain decoder at the main path's shapes")
    u_head = u[:, :prefix].cpu().numpy()
    k2_head = k2_dec[:, :prefix].cpu().numpy()
    _require(all((dec[j, : hl[j]] == u_head[j, : hl[j]]).all()
                 and (k2_head[j, : hl[j]] == dec[j, : hl[j]]).all() for j in range(blocks)),
             "K3b does not give back the rows' first symbols, or K2 differs from it")
    bits = 8 * int(lens.max())
    out.update({
        "shape": [blocks, width], "row_lens": lens.tolist(), "payload_lens": pl,
        "k3a_equal_k1": True, "k2_equal_k3b": True,
        "k1_one_launch_ms": k1_ms, "k3a_ms": k3a_ms,
        "k2_one_launch_ms": k2_ms, "k3b_ms": k3b_ms,
        "k3a_over_k1": k3a_ms / k1_ms, "k3b_over_k2": k3b_ms / k2_ms,
        "ns_per_bit_step": {"k1": k1_ms * 1e6 / bits, "k3a": k3a_ms * 1e6 / bits,
                            "k2": k2_ms * 1e6 / bits, "k3b": k3b_ms * 1e6 / bits},
        "timing": "CUDA events around each launch",
        "prefix": prefix, "k3b_prefix_max_abs_err": k3b_err, "k3b_plain_prefix_ms": k3b_plain_ms,
    })
    emit(out)
    return out


def phase_main_oversize(card: str, data: bytes, b32: dict, prefix: int = 2048,
                        cap_mib: int = 32) -> dict:
    """One block of len(data) bytes through the stream API, past a
    device-block cap of ``cap_mib`` set for the phase
    (BZ3_TPU_MAX_DEVICE_BLOCK_MIB): the host-BWT hybrid with K3a and
    K3c, each launch timed as it runs.  The same block through the
    default path (the wave path, which takes every block size on an H100
    80GB) must give the same stream.  The host SA-IS is held against the
    device BWT on the block's own post-prepass row; K3a's payload and
    K3c's output at the full width against the plain encoder and decoder
    on the row's first ``prefix`` symbols.  K3a's and K3c's ns a bit step
    on the row against K1's and K2's in one launch in ``b32``."""
    import torch
    from bzip3_tpu_torch import compress_file
    from bzip3_tpu_torch.engines import DeviceEngine
    from bzip3_tpu_torch.ops import host
    from bzip3_tpu_torch.ops.device import cm, cm_cuda
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch
    from bzip3_tpu_torch.pipeline import host_prepass

    bs = len(data)
    _require(os.environ.get("BZ3_TPU_FORCE_OVERSIZE", "0") != "1", "oversize forced")
    _require(bs > cap_mib * MiB, (bs, cap_mib))
    with _env(BZ3_TPU_MAX_DEVICE_BLOCK_MIB=str(cap_mib)), \
            _LaunchTimes("bz3t_cm_encode_resume", "bz3t_cm_decode_resume") as lt:
        eng, comp, out = _round_trip(card, "main_oversize", data, bs, 1)
        _require(eng._pipe(bs).oversize, "the pipeline did not take the oversize path")
    wave_eng = DeviceEngine("cuda")
    _require(not wave_eng._pipe(bs).oversize, "the default path took the hybrid")
    t0 = time.perf_counter()
    twin = io.BytesIO()
    compress_file(io.BytesIO(data), twin, bs, engine=wave_eng, batch_size=1)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    _require(twin.getvalue() == comp, "the hybrid's stream differs from the default path's")
    _require(out["stage_calls"].get("decode/crc_verify") == 1, "the CRC was not checked")
    [(hdr, pay)] = _payloads(comp, bs)
    _require(hdr.model & 2, f"LZP not kept: model {hdr.model}")

    model, _, _, cur = host_prepass(data)
    n = len(cur)
    launches = out["launches"]
    want = -(-n // cm.default_chunk_steps())
    _require({k for k, v in launches.items() if v} == set(OVERSIZE_PATH)
             and launches["cm_encode_resume"] == launches["cm_decode_stream"] == want,
             f"launches {launches}, want {want} of K3a and K3c")
    (k3a_ms, na), (k3c_ms, nc) = lt.ms("bz3t_cm_encode_resume"), lt.ms("bz3t_cm_decode_resume")
    _require(na == nc == want, f"timed {na} K3a and {nc} K3c launches, want {want}")
    t0 = time.perf_counter()
    u, idx = host.bwt_forward(cur)
    sais_s = time.perf_counter() - t0
    _require(idx == hdr.bwt_idx, "host SA-IS index differs from the stream's")
    torch.cuda.reset_peak_memory_stats()
    row = torch.from_numpy(np.frombuffer(cur, np.uint8).copy())[None].cuda()
    t0 = time.perf_counter()
    du, didx = bwt_forward_batch(row, torch.tensor([n], dtype=torch.int32).cuda())
    torch.cuda.synchronize()
    device_bwt_s = time.perf_counter() - t0
    _require(int(didx[0]) == idx and du[0, :n].cpu().numpy().tobytes() == u,
             "host SA-IS differs from the device BWT")
    bwt_peak = torch.cuda.max_memory_allocated()
    del row, du

    head = torch.from_numpy(np.frombuffer(u[:prefix], np.uint8).copy())[None]
    t0 = time.perf_counter()
    p_out, p_len = cm.cm_encode_batch(head, torch.tensor([prefix], dtype=torch.int32))
    plain_ms = (time.perf_counter() - t0) * 1e3
    m = int(p_len[0]) - 4  # all but the flush
    err = _row_diff(np.frombuffer(pay[:m], np.uint8), p_out[0, :m].numpy())
    _require(err == 0, "K3a differs from the plain encoder on the oversize row's prefix")

    # K3c on the stream's payload at the full width, the row cut to its
    # first symbols: the first piece against the plain decoder
    d_pay = torch.from_numpy(np.frombuffer(pay, np.uint8).copy())[None].cuda()
    d_plen = torch.tensor([len(pay)], dtype=torch.int32).cuda()
    h = min(n, prefix, cm.default_chunk_steps())  # inside the first piece
    head = torch.tensor([h], dtype=torch.int32).cuda()
    pieces = list(cm_cuda.cm_decode_stream(d_pay, d_plen, head, n))
    _require(len(pieces) == want and pieces[0][0] == 0, "K3c pieces")
    dec = pieces[0][1][:, :h].cpu().numpy()
    k3c_err, k3c_plain_ms = _decode_prefix_err(dec, d_pay, d_plen, [h], h)
    _require(k3c_err == 0, "K3c differs from the plain decoder on the oversize row's prefix")
    _require(dec[0].tobytes() == u[:h], "K3c does not give back the row's first symbols")
    del pieces, d_pay
    out.update({
        "block_mib": bs / MiB, "oversize": True, "cap_mib": cap_mib,
        "default_path_equal": True, "default_path_encode_s": twin_s,
        "model": hdr.model, "post_prepass_len": n,
        "payload_len": len(pay), "launches_wanted": want, "host_sais_s": sais_s,
        "host_inverse_s": out["stages_s"]["decode/bwt"], "device_bwt_s": device_bwt_s,
        "device_bwt_peak_bytes": bwt_peak, "sais_equal_device_bwt": True,
        "prefix": prefix, "k3a_prefix_max_abs_err": err, "k3a_plain_prefix_ms": plain_ms,
        "k3c_prefix_max_abs_err": k3c_err, "k3c_plain_prefix_ms": k3c_plain_ms,
        "k3a_ms": k3a_ms, "k3c_ms": k3c_ms, "timing": "CUDA events around each launch",
        "ns_per_bit_step": {"k3a": k3a_ms * 1e6 / (8 * n), "k3c": k3c_ms * 1e6 / (8 * n)},
        "k3a_over_k1": k3a_ms * 1e6 / (8 * n) / b32["ns_per_bit_step"]["k1"],
        "k3c_over_k2": k3c_ms * 1e6 / (8 * n) / b32["ns_per_bit_step"]["k2"],
    })
    emit(out)
    return out


def wide_pool(data: bytes, pdata: bytes, fresh: bytes, bs: int) -> list[bytes]:
    """The distinct pieces of ``bs`` bytes of text and log lines that the
    run already holds: main's 8 text blocks, main_prepass's 3 of log
    lines (at 0, 9 and 18) and main_wave's 16 fresh text blocks, 27 in
    all (main_prepass's text blocks are main's first 4)."""
    text = [data[i * bs : (i + 1) * bs] for i in range(8)]
    text += [fresh[i * bs : (i + 1) * bs] for i in range(len(fresh) // bs)]
    log = [pdata[i * bs : (i + 1) * bs] for i in range(4, 7)]
    pool = text[:]
    for j, piece in enumerate(log):
        pool.insert(9 * j, piece)
    return pool


def wide_blocks(pool: list[bytes], blocks: int, per_block: int, stride: int = 7) -> bytes:
    """``blocks`` blocks of ``per_block`` pieces of ``pool``: block j takes
    pieces (stride * j + i) mod len(pool), so no piece repeats inside a
    block and no two blocks are alike."""
    _require(per_block <= len(pool) and stride * (blocks - 1) < len(pool), "pool too small")
    return b"".join(pool[(stride * j + i) % len(pool)]
                    for j in range(blocks) for i in range(per_block))


def _relabel(piece: bytes, key: int) -> bytes:
    """``piece`` with every byte xored with ``key``: its statistics kept,
    none of its byte strings."""
    return (np.frombuffer(piece, np.uint8) ^ np.uint8(key)).tobytes()


def phase_main_wide(card: str, data: bytes, bs: int, over: dict,
                    prefix: int = 2048) -> tuple[dict, bytes]:
    """Blocks past 128 MiB on the wave path: len(data) // bs blocks of
    ``bs`` bytes (text and log lines) through ``compress_file`` /
    ``decompress_file`` in one batch.  No block takes the hybrid; the
    rows form one wave, so K3a and K3b launch ceil(steps / 16 Mi) times
    for all rows together (the longest row's padded width); round trip
    equal, no row coded again.  The first row's payload must equal the
    plain encoder on its first ``prefix`` symbols (the BWT of its
    post-prepass row on the card).  Stage times, the BWT and inverse
    groups, MiB/s and peak memory, beside the hybrid's MiB/s in
    main_oversize.  (result line, compressed stream)"""
    import torch
    from bzip3_tpu_torch.ops.device import cm
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch
    from bzip3_tpu_torch.pipeline import bwt_row_groups, host_prepass, inverse_row_groups

    blocks = len(data) // bs
    with _LaunchTimes("bz3t_cm_encode_resume", "bz3t_cm_decode_resume") as lt:
        eng, comp, out = _round_trip(card, "main_wide", data, bs, blocks)
    pipe = eng._pipe(bs)
    _require(not pipe.oversize, "main_wide took the host-BWT hybrid")
    rows = [host_prepass(data[i * bs : (i + 1) * bs])[3] for i in range(blocks)]
    n = len(rows[0])
    width = -(-max(map(len, rows)) // 256) * 256
    want = -(-width // cm.default_chunk_steps())
    launches, calls = out["launches"], out["stage_calls"]
    _require({k for k, v in launches.items() if v} == set(B32_PATH)
             and launches["cm_encode_resume"] == launches["cm_decode_resume"] == want,
             f"main_wide: launches {launches}, want {want} of K3a and K3b (one wave)")
    (k3a_ms, na), (k3b_ms, nb) = lt.ms("bz3t_cm_encode_resume"), lt.ms("bz3t_cm_decode_resume")
    _require(na == nb == want, f"timed {na} K3a and {nb} K3b launches, want {want}")
    g = bwt_row_groups(blocks, width, pipe.device)
    ig = inverse_row_groups(blocks, width, pipe.device)
    _require(calls["encode/bwt"] == -(-blocks // g) and calls["decode/bwt"] == -(-blocks // ig),
             f"main_wide: groups {calls}, planned {g} and {ig} rows")

    payloads = _payloads(comp, bs)[:blocks]
    hdr, pay = payloads[0]
    row = torch.from_numpy(np.frombuffer(rows[0], np.uint8).copy())[None].cuda()
    u, idx = bwt_forward_batch(row, torch.tensor([n], dtype=torch.int32).cuda())
    _require(int(idx[0]) == hdr.bwt_idx, "main_wide: the first row's index differs")
    head = u[:, :prefix].cpu()
    del row, u
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p_out, p_len = cm.cm_encode_batch(head, torch.tensor([prefix], dtype=torch.int32))
    plain_ms = (time.perf_counter() - t0) * 1e3
    m = int(p_len[0]) - 4  # all but the flush
    err = _row_diff(np.frombuffer(pay[:m], np.uint8), p_out[0, :m].numpy())
    _require(err == 0, "K3a differs from the plain encoder on main_wide's first row")
    bits = 8 * width
    out.update({
        "oversize": False, "waves": 1, "row_lens": list(map(len, rows)), "width": width,
        "payload_lens": [len(p) for _, p in payloads],
        "launches_wanted": want, "bwt_group_rows": g, "inverse_group_rows": ig,
        "bwt_groups": calls["encode/bwt"], "inverse_groups": calls["decode/bwt"],
        "k3a_ms": k3a_ms, "k3b_ms": k3b_ms, "timing": "CUDA events around each launch",
        "ns_per_bit_step": {"k3a": k3a_ms * 1e6 / bits, "k3b": k3b_ms * 1e6 / bits},
        "prefix": prefix, "k3a_prefix_max_abs_err": err, "k3a_plain_prefix_ms": plain_ms,
        "hybrid_mib_s": [over["encode_mib_s"], over["decode_mib_s"]],
        "over_hybrid": [out["encode_mib_s"] / over["encode_mib_s"],
                        out["decode_mib_s"] / over["decode_mib_s"]],
    })
    emit(out)
    return out, comp


def phase_main_wide_prepass(card: str, data: bytes, bs: int, wide: dict, stream: bytes) -> dict:
    """main_wide's blocks on the device chain (``BZ3_TPU_DEVICE_PREPASS=1``:
    CRC, RLE and LZP on the card, its RLE in the planned row groups): the wave
    path in one wave, K3a and K3b launched as in main_wide, one K5 and one
    K6 launch for the wave, its stream equal to main_wide's, round trip
    equal, no row coded again, peak device memory within ``MEM_SHARE``
    of the card."""
    import torch
    from bzip3_tpu_torch.pipeline import MEM_SHARE, chain_row_groups

    blocks = len(data) // bs
    with _env(BZ3_TPU_DEVICE_PREPASS="1"):  # the switch as a deployment sets it
        eng, comp, out = _round_trip(card, "main_wide_prepass", data, bs, blocks)
    pipe = eng._pipe(bs)
    _require(pipe.device_prepass, "main_wide_prepass: BZ3_TPU_DEVICE_PREPASS=1 was not read")
    _require(not pipe.oversize, "main_wide_prepass took the hybrid")
    _require(comp == stream, "main_wide_prepass: stream differs from main_wide's")
    launches, calls = out["launches"], out["stage_calls"]
    want = wide["launches_wanted"]
    _require({k for k, v in launches.items() if v} == {"crc_lanes", "lzp_encode", "lzp_decode",
                                                        *B32_PATH}
             and launches["cm_encode_resume"] == launches["cm_decode_resume"] == want,
             f"main_wide_prepass: launches {launches}, want {want} of K3a and K3b (one wave)")
    g = chain_row_groups(blocks, pipe.width, pipe.device)
    _require(calls["encode/rle"] == calls["decode/rle"] == -(-blocks // g)
             and launches["lzp_encode"] == launches["lzp_decode"] == 1,
             f"main_wide_prepass: RLE groups {calls}, planned {g} rows; one K5 and one K6 "
             f"launch for the wave: {launches}")
    total = torch.cuda.get_device_properties(0).total_memory
    _require(out["peak_device_bytes"] <= MEM_SHARE * total,
             f"main_wide_prepass: peak {out['peak_device_bytes']} past the planned share")
    out.update({"oversize": False, "identical_to_main_wide": True, "chain_group_rows": g,
                "chain_groups": calls["encode/rle"], "peak_reserved_bytes":
                torch.cuda.max_memory_reserved(), "total_memory": total})
    emit(out)
    return out


def device_peak(fn, n: int):
    """(result, seconds, peak bytes a byte of ``n``) of ``fn()`` on the
    card: the peak of what it allocates over what was allocated before
    it, its n-byte input counted, and the same of what the allocator
    reserves ("allocated", "reserved")."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base, base_res = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return res, sec, {"allocated": (torch.cuda.max_memory_allocated() - base + n) / n,
                      "reserved": (torch.cuda.max_memory_reserved() - base_res + n) / n}


def phase_wide_bwt(card: str, pool: list[bytes], sizes=(256 * MiB, 511 * MiB),
                   sais_at: int = 256 * MiB) -> dict:
    """The forward and inverse BWT alone on one row of each of ``sizes``
    bytes, cut from ``pool`` (its pieces in order, then pieces relabeled
    by ``_relabel`` where the pool runs short): seconds and peak bytes a
    byte of each; inverse(forward(x)) == x, and at ``sais_at`` the
    forward equal to the host SA-IS."""
    import torch
    from bzip3_tpu_torch.ops import host
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch, bwt_inverse_batch

    res = {}
    for n in sizes:
        pieces = -(-n // len(pool[0]))
        src = pool + [_relabel(p, 0xA5) for p in pool]
        row = np.frombuffer(b"".join(src[:pieces]), np.uint8)[:n]
        x = torch.from_numpy(row.copy())[None].cuda()
        lens = torch.tensor([n], dtype=torch.int32).cuda()
        (u, idx), fwd_s, fwd_peak = device_peak(lambda: bwt_forward_batch(x, lens), n)
        back, inv_s, inv_peak = device_peak(lambda: bwt_inverse_batch(u, lens, idx), n)
        _require(torch.equal(back, x), f"wide_bwt: inverse(forward(x)) != x at {n}")
        del back, x
        r = {"forward_s": fwd_s, "forward_peak_bytes_a_byte": fwd_peak["allocated"],
             "forward_peak_reserved_bytes_a_byte": fwd_peak["reserved"],
             "inverse_s": inv_s, "inverse_peak_bytes_a_byte": inv_peak["allocated"],
             "inverse_peak_reserved_bytes_a_byte": inv_peak["reserved"], "round_trip": True}
        if n == sais_at:
            t0 = time.perf_counter()
            hu, hidx = host.bwt_forward(row.tobytes())
            r["host_sais_s"] = time.perf_counter() - t0
            _require(hidx == int(idx[0]) and u[0].cpu().numpy().tobytes() == hu,
                     f"wide_bwt: the device BWT differs from the host SA-IS at {n}")
            r["equal_host_sais"] = True
        del u
        torch.cuda.empty_cache()
        res[str(n)] = r
    out = {"phase": "wide_bwt", "card": card, "rows": res}
    emit(out)
    return out


@contextlib.contextmanager
def _env(**kv):
    """Environment variables set for the block inside, then restored."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def parallel_hazards(n: int) -> list[bytes]:
    """The JAX package's rows for the parallel CM encoder
    (tests/test_device_ops.py:226-245), before the BWT: skewed b"aab" and
    text, rows of differing lengths, an empty row and random bytes."""
    rng = np.random.default_rng(77)
    skew = rng.choice(np.frombuffer(b"aab", np.uint8), size=n, p=[0.6, 0.3, 0.1]).tobytes()
    text = corpus(2 * n, seed=4)
    return [skew, text[:n], text[n : n + n // 2], b"",
            rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes()]


class _Calls:
    """The calls of ``cm_parallel_cuda``'s P1 and P2 wrappers while
    active: (arguments, result, host milliseconds) of each or, with
    ``check``, what ``check(name, arguments, result)`` returns, right
    after the call (nothing of the call is kept)."""

    NAMES = ("chain_windows", "range_pass")

    def __init__(self, check=None):
        self.check = check

    def __enter__(self):
        from bzip3_tpu_torch.ops.device import cm_parallel_cuda as cp

        self.cp, self.real = cp, {k: getattr(cp, k) for k in self.NAMES}
        self.calls = {k: [] for k in self.NAMES}

        def wrap(name):
            def fn(*a):
                t0 = time.perf_counter()
                res = self.real[name](*a)
                ms = (time.perf_counter() - t0) * 1e3
                self.calls[name].append((a, res, ms) if self.check is None
                                        else self.check(name, a, res))
                return res
            return fn

        for k in self.NAMES:
            setattr(cp, k, wrap(k))
        return self

    def __exit__(self, *exc) -> None:
        for k in self.NAMES:
            setattr(self.cp, k, self.real[k])


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _int_err(a, b) -> int:
    _require(a.shape == b.shape, f"shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


TRACE_DIR = os.path.join(ROOT, "_build", "trace_parity_parallel")


def phase_parity_parallel(card: str, n: int = 1024) -> dict:
    """P1 (each mode, each rate) and P2 on the card against their plain
    versions on CPU copies of the same inputs, and the parallel encoder on
    the card against its CPU run: the hazard rows after the BWT at seg 128
    and 2048 and in the exact mode.  Every call of the card's run is held
    against the same call of the CPU run (equal inputs, equal outputs); P2
    once more with an output cap.  The card's runs go under ``trace``,
    whose Chrome trace must name both kernels."""
    import torch
    from bzip3_tpu_torch.ops.device import cm_parallel, cm_parallel_cuda as cp
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch
    from bzip3_tpu_torch.utils.profiling import trace

    rows = parallel_hazards(n)
    arr, lens = _pad(rows, n)
    l_gpu = torch.from_numpy(lens).cuda()
    u, _ = bwt_forward_batch(torch.from_numpy(arr).cuda(), l_gpu)
    u_cpu, l_cpu = u.cpu(), l_gpu.cpu()
    configs = [(128, True), (2048, True), (128, False)]
    before = launch_counts()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    card_runs = {}
    with trace(TRACE_DIR):
        for seg, spec in configs:
            with _Calls() as c:
                res = cm_parallel.cm_encode_parallel_batch(u, l_gpu, seg=seg, speculative=spec)
                card_runs[(seg, spec)] = (tuple(t.cpu() for t in res), c.calls)
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    err = {"p1": 0, "p2": 0}
    modes, plain_ms, encoder = {}, {"p2": 0.0}, {}
    for seg, spec in configs:
        got, kcalls = card_runs[(seg, spec)]
        t0 = time.perf_counter()
        with _Calls() as c:
            want = cm_parallel.cm_encode_parallel_batch(u_cpu, l_cpu, seg=seg, speculative=spec)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        _require(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]) and bool(want[2].all()),
                 f"seg {seg}: lengths {got[1].tolist()} / {want[1].tolist()}, ok {got[2].tolist()}")
        for i in range(len(rows)):
            m = int(want[1][i])
            _require(torch.equal(got[0][i, :m], want[0][i, :m]), f"seg {seg}, row {i} differs")
        for name in _Calls.NAMES:
            _require(len(kcalls[name]) == len(c.calls[name]),
                     f"{name}: {len(kcalls[name])} calls on the card, {len(c.calls[name])} on the CPU")
            for (ka, kres, _), (pa, pres, pms) in zip(kcalls[name], c.calls[name]):
                for x, y in zip(ka, pa):  # the same inputs
                    _require(torch.equal(x.cpu(), y) if isinstance(x, torch.Tensor) else x == y,
                             f"{name}: inputs differ")
                if name == "range_pass":  # bytes past a payload's length are not written
                    (kout, klens), (pout, plens) = kres, pres
                    e = _int_err(klens.cpu(), plens)
                    for i, m in enumerate(plens.clamp(max=pout.shape[1]).tolist()):
                        e = max(e, _int_err(kout[i, :m].cpu(), pout[i, :m]))
                else:
                    e = max(_int_err(x.cpu(), y) for x, y in zip(_as_tuple(kres), _as_tuple(pres)))
                if name == "range_pass":
                    err["p2"] = max(err["p2"], e)
                    plain_ms["p2"] += pms
                    continue
                err["p1"] = max(err["p1"], e)
                ev, rate, mode = ka[:3]
                key = f"{mode}_rate{rate}"
                if seg == 2048 and key not in modes:  # the card's time of one call a mode
                    modes[key] = {"shape": list(ev.shape), "plain_ms": pms, "ms": _cuda_ms(
                        lambda a=ka: cp.chain_windows(*a), 3)}
        encoder[f"seg{seg}_{'speculative' if spec else 'exact'}"] = {
            "payload_lens": want[1].tolist(), "ok": want[2].tolist(), "cpu_ms": cpu_ms,
            "p1_calls": len(kcalls["chain_windows"])}
    _require(err["p1"] == 0, "P1 differs from its plain version")
    _require(err["p2"] == 0, "P2 differs from its plain version")
    _require(len({k.split("_")[0] for k in modes}) == 3, f"modes timed {sorted(modes)}")

    # P2 with a cap under the payloads: true lengths, exact bytes under it
    (words, plens, width), _, _ = card_runs[(128, True)][1]["range_pass"][0]
    cap = max(8, int(card_runs[(128, True)][0][1].max()) // 2)
    k_out, k_lens = (t.cpu() for t in cp.range_pass(words, plens, cap))
    p_out, p_lens = cm_parallel.range_pass_plain(words.cpu(), plens.cpu(), cap)
    _require(torch.equal(k_lens, p_lens) and bool((p_lens > cap).any()), f"capped P2 {k_lens.tolist()}")
    for i in range(len(rows)):
        m = min(int(p_lens[i]), cap)
        _require(torch.equal(k_out[i, :m], p_out[i, :m]), f"capped P2 row {i}")
    p2_ms = _cuda_ms(lambda: cp.range_pass(words, plens, width), 3)

    # the trace names both kernels; their summed device time in it
    files = os.listdir(TRACE_DIR)
    _require(len(files) == 1, f"trace files {files}")
    with open(os.path.join(TRACE_DIR, files[0])) as f:
        events = json.load(f)["traceEvents"]
    traced = {}
    for e in events:
        for k in ("chain_windows_kernel", "range_pass_kernel"):
            if k in str(e.get("name", "")) and str(e.get("cat", "")).lower() == "kernel":
                d = traced.setdefault(k, {"launches": 0, "us": 0.0})
                d["launches"] += 1
                d["us"] += float(e.get("dur", 0))
    _require(set(traced) == {"chain_windows_kernel", "range_pass_kernel"},
             f"trace names {sorted(traced)}")
    out = {
        "phase": "parity_parallel", "card": card, "rows": len(rows), "width": n,
        "row_lens": lens.tolist(), "tolerance": 0, "encoder": encoder,
        "p1": {"max_abs_err": err["p1"], "modes": modes, "plain_device": "cpu"},
        "p2": {"max_abs_err": err["p2"], "ms": p2_ms, "plain_ms": plain_ms["p2"] / len(configs),
               "plain_device": "cpu", "cap": cap, "capped_lens": k_lens.tolist()},
        "parity_launches": launches, "trace": {"file": files[0], "kernels": traced,
                                               "events": len(events)},
    }
    emit(out)
    return out


P2_PREFIX = 4096  # bytes a row of P2 held against its plain version at the main shape


def _held_to_plain(name: str, args, res) -> dict:
    """One P1 or P2 call at the main path's shape against its plain
    version.  P1: ``chain_windows_plain`` on the same card tensors, in
    full.  P2: ``range_pass_plain`` on CPU copies of each row's first
    ``P2_PREFIX`` bytes of words: the coder never carries into a byte it
    has written, so the prefix's payload less its 4 flush bytes (all of
    it, with its length, for a row that fits the prefix) is the start of
    the row's payload."""
    from bzip3_tpu_torch.ops.device import cm_parallel

    if name == "chain_windows":
        want = cm_parallel.chain_windows_plain(*args)
        err = max(_int_err(x, y) for x, y in zip(_as_tuple(res), _as_tuple(want)))
        return {"mode": args[2], "rate": args[1], "shape": list(args[0].shape), "max_abs_err": err}
    words, lens, width = args
    kout, klens = res
    pre = lens.clamp(max=P2_PREFIX).cpu()
    pout, plens = cm_parallel.range_pass_plain(words[:, : 8 * P2_PREFIX].cpu(), pre, width)
    whole = (lens.cpu() <= P2_PREFIX).tolist()
    kpre = kout[:, : int(plens.max())].cpu()
    klens = klens.cpu()
    err, compared = 0, 0
    for i, m in enumerate(plens.tolist()):
        m = m if whole[i] else m - 4
        err = max(err, _int_err(kpre[i, :m], pout[i, :m]))
        if whole[i]:
            err = max(err, abs(int(klens[i]) - int(plens[i])))
        compared += m
    return {"rows": len(whole), "prefix_bytes": P2_PREFIX, "payload_bytes_compared": compared,
            "max_abs_err": err}


def _p1_work(args) -> tuple[int, int]:
    """(bytes, operations) of one P1 launch from its C arguments: the
    events read once, the entries read and the exits or values written;
    a step of each event on each state (2 in a pair pass, 2^rate in a
    map pass, 1 in an emit pass)."""
    k, seg, s, rate, mode = args[1:6]
    events = k * seg * s
    states = (2, 1 << rate, 1)[mode]
    io_bytes = (16 * k * s, 4 * k * s * (1 + (1 << rate)), 4 * k * s + 4 * events)[mode]
    return 4 * events + io_bytes, OPS_PER_EVENT * events * states


def phase_main_parallel(card: str, data: bytes, parity: dict, lat: dict, bs: int = 2 * MiB,
                        blocks: int = 16) -> dict:
    """The parallel CM encoder on the path a user selects with
    BZ3_TPU_CM=parallel, at -b 2 (the widest wave it takes): ``blocks`` x
    ``bs`` of text through ``compress_file`` / ``decompress_file``, P1 and
    P2 timed launch by launch as they run.  The stream must equal the K1
    route's on the same data, every row certify (no row coded again), and
    the golden streams re-encode on this route at -b 1.  Then the encoder
    against K1 by CUDA events on the blocks' post-BWT rows at [1, N] and
    [blocks, N], each with its peak device memory a byte of input, its
    payloads equal to K1's; the stage times of the [blocks, N] run;
    ``torch.sort`` alone at C1's key shape; and each P1 and P2 call of
    the [blocks, N] encode held against its plain version
    (``_held_to_plain``).  P2's serial bound: 8 bit steps a byte of the
    longest row at the coder chain's time a step (phase_latency)."""
    import torch
    from bzip3_tpu_torch import compress_file, decompress_file
    from bzip3_tpu_torch.engines import DeviceEngine
    from bzip3_tpu_torch.ops.device import cm_cuda, cm_parallel_cuda as cp
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch
    from bzip3_tpu_torch.pipeline import host_prepass
    from bzip3_tpu_torch.utils.profiling import StageTimer

    with _env(BZ3_TPU_CM="parallel"):
        with _LaunchTimes("bz3t_chain_windows", "bz3t_range_pass") as lt:
            eng, comp, out = _round_trip(card, "main_parallel", data, bs, blocks)
        launches, enc = out["launches"], out["encode_launches"]
        _require({k for k, v in launches.items() if v} == set(PARALLEL_PATH)
                 and enc["cm_encode"] == 0, launches)
        golden = {}
        for name in GOLDEN:
            with open(os.path.join(ROOT, "tests", "data", name), "rb") as f:
                gold = f.read()
            plain = io.BytesIO()
            decompress_file(io.BytesIO(gold), plain, engine=DeviceEngine("cuda"), batch_size=8)
            gbs = int.from_bytes(gold[5:9], "little")
            again = io.BytesIO()
            geng = DeviceEngine("cuda")
            reset_launches()
            compress_file(io.BytesIO(plain.getvalue()), again, gbs, engine=geng, batch_size=8,
                          feof_block=False)
            gl = launch_counts()
            _require(again.getvalue() == gold, f"{name}: re-encode on the parallel route differs")
            _require(gl["range_pass"] > 0 and gl["cm_encode"] == 0 and geng.reencoded_rows == 0,
                     f"{name}: launches {gl}")
            golden[name] = {"block_size": gbs, "identical": True, "range_pass_launches": gl["range_pass"]}
    k1_stream = io.BytesIO()
    compress_file(io.BytesIO(data), k1_stream, bs, engine=DeviceEngine("cuda"), batch_size=blocks)
    _require(k1_stream.getvalue() == comp, "the parallel route's stream differs from K1's")

    # P1 and P2 as the main path ran them: times, bounds from their inputs
    p1 = lt.launches("bz3t_chain_windows")
    p2 = lt.launches("bz3t_range_pass")
    rows = [host_prepass(data[i * bs : (i + 1) * bs])[3] for i in range(blocks)]
    pays = [len(p) for _, p in _payloads(comp, bs)[:blocks]]
    _require(len(p2) == launches["range_pass"] and len(p1) == launches["chain_windows"],
             "timed launches")
    w1 = [_p1_work(a) for _, a in p1]
    p1_bound = _bound(sum(b for b, _ in w1), sum(o for _, o in w1))
    nbits = 8 * sum(map(len, rows))
    p2_bound = _bound(4 * nbits + sum(pays) + 8 * blocks, OPS_PER_P2_BIT * nbits)
    ns_k1 = parity["k2_k1_1MiB"]["k1_ns_per_bit"]
    chain = lat["coder_chain"]
    by_mode = {}
    for ms, a in p1:
        d = by_mode.setdefault(("pair", "map", "emit")[a[5]], {"launches": 0, "ms": 0.0})
        d["launches"] += 1
        d["ms"] += ms
    out.update({
        "golden": golden, "equal_to_k1_stream": True,
        "p1": {"launches": len(p1), "ms": sum(ms for ms, _ in p1), "by_mode": by_mode,
               "bound_ms": p1_bound[0], "bound_by": p1_bound[1]},
        "p2": {"launches": len(p2), "ms": sum(ms for ms, _ in p2), "bound_ms": p2_bound[0],
               "bound_by": p2_bound[1], "serial_bound_ms": 8 * max(map(len, rows)) * chain["ns"] * 1e-6,
               "serial_bound_from": "phase_latency's coder chain", "chain_ns_per_bit": chain["ns"],
               "chain_cycles_per_bit": chain["cycles"], "k1_ns_per_bit": ns_k1},
        "relax_rounds": out["stage_calls"].get("encode/cm/p1_relax", 0),
        "cm_stages_s": {k: v for k, v in out["stages_s"].items() if k.startswith("encode/cm")},
        "row_lens": list(map(len, rows)), "payload_lens": pays,
    })

    # the encoder against K1 on the blocks' post-BWT rows
    width = -(-max(map(len, rows)) // 256) * 256
    arr, lens = _pad(rows, width)
    l_gpu = torch.from_numpy(lens).cuda()
    u, _ = bwt_forward_batch(torch.from_numpy(arr).cuda(), l_gpu)
    shapes = {}
    for k in (1, blocks):
        uk, lk = u[:k].contiguous(), l_gpu[:k].contiguous()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (pout, plens, ok), par_ms = _timed(lambda: cp.cm_encode_parallel(uk, lk))
        peak = torch.cuda.max_memory_allocated() - base
        (kout, klens), k1_ms = _timed(lambda: cm_cuda.cm_encode(uk, lk))
        _require(bool(ok.all()) and torch.equal(plens, klens), f"[{k}]: ok {ok.tolist()}")
        inside = torch.arange(pout.shape[1], device=u.device)[None, :] < plens[:, None]
        _require(torch.equal(torch.where(inside, pout, 0), torch.where(inside, kout, 0)),
                 f"[{k}, {width}]: payloads differ from K1's")
        shapes[f"{k}x{width}"] = {
            "parallel_ms": par_ms, "k1_ms": k1_ms, "parallel_over_k1": par_ms / k1_ms,
            "peak_bytes": peak, "peak_bytes_per_input_byte": peak / (k * width)}
        del pout, kout
    timer = StageTimer(enabled=True, sync=torch.cuda.synchronize)
    _, staged_ms = _timed(lambda: cp.cm_encode_parallel(u, l_gpu, timer=timer))
    # torch.sort alone at C1's keys: [blocks, 16 N] int64, slot << 32 |
    # time, the slots scattered by a multiplicative hash of the time
    t = torch.arange(16 * width, device="cuda").expand(blocks, -1)
    keys = (((t * 2654435761) >> 7) & 0xFFFF) << 32 | t
    sort_ms = _cuda_ms(lambda: torch.sort(keys, dim=1, stable=True), 2)
    del keys
    # every P1 and P2 call of the [blocks, N] encode against its plain version
    t0 = time.perf_counter()
    with _Calls(check=_held_to_plain) as c:
        cp.cm_encode_parallel(u, l_gpu)
    held = c.calls
    held_s = time.perf_counter() - t0
    _require(len(held["chain_windows"]) == launches["chain_windows"]
             and len(held["range_pass"]) == 1, f"held calls {held}")
    _require({h["mode"] for h in held["chain_windows"]} == {"pair", "map", "emit"}, held)
    p1_err = max(h["max_abs_err"] for h in held["chain_windows"])
    p2_err = held["range_pass"][0]["max_abs_err"]
    _require(p1_err == 0, f"P1 at [{blocks}, {width}] differs from its plain version: {held}")
    _require(p2_err == 0, f"P2 at [{blocks}, {width}] differs from its plain version: {held}")
    out["p1"]["max_abs_err"], out["p2"]["max_abs_err"] = p1_err, p2_err
    out["held_to_plain"] = {"p1_passes": held["chain_windows"], "p2": held["range_pass"][0],
                            "plain_device": {"p1": "cuda", "p2": "cpu"}, "tolerance": 0,
                            "s": held_s}
    out.update({"shapes": shapes, "timing": "CUDA events around each call",
                "staged_ms": staged_ms,
                "staged": {k: round(v * 1e3, 3) for k, v in timer.totals.items()},
                "staged_calls": dict(timer.counts),
                "torch_sort_c1_keys_ms": sort_ms, "group_bytes": cp.GROUP_BYTES})
    emit(out)
    return out


def phase_main_wave(card: str, data: bytes, pdata: bytes, fresh: bytes, stream: bytes,
                    pstream: bytes, bs: int, probe_n: int = MiB) -> dict:
    """One wave that fills the card: main's 8 text blocks, main_prepass's
    8 (text, log lines, sparse) and the blocks of ``fresh`` seeded text
    at -b 16 through ``compress_file`` / ``decompress_file`` in one batch.
    Its first 16 blocks must equal main's and main_prepass's; K1 and K2
    launch once each; no row is coded again.  Prints the stage times (the
    pool's pre-pass wait, each BWT group), the BWT and inverse groups,
    peak memory and MiB/s.  Then K1 and K2 on post-BWT rows of
    ``probe_n`` bytes at [1, probe_n] and at [SMs, probe_n], and their
    ratios: whether a launch still takes one row's time when every SM
    holds a row."""
    import torch
    from bzip3_tpu_torch.ops.device import cm_cuda
    from bzip3_tpu_torch.pipeline import bwt_row_groups, wave_rows
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch

    wdata = data[: 8 * bs] + pdata[: 8 * bs] + fresh
    blocks = len(wdata) // bs
    _, comp, out = _round_trip(card, "main_wave", wdata, bs, blocks)
    got = _chunks(comp, bs)
    _require(got[:8] == _chunks(stream, bs)[:8], "main_wave: blocks 0-7 differ from main's")
    _require(got[8:16] == _chunks(pstream, bs)[:8],
             "main_wave: blocks 8-15 differ from main_prepass's")
    launches, calls = out["launches"], out["stage_calls"]
    _require({k for k, v in launches.items() if v} == set(DEFAULT_PATH), launches)
    _require(launches["cm_encode"] == 1 and launches["cm_decode"] == 1,
             f"main_wave: K1/K2 launched {launches}, once each wanted")
    out.update(identical_blocks=16, wave_rows=wave_rows(["cuda:0"]),
               bwt_groups=calls["encode/bwt"], inverse_groups=calls["decode/bwt"],
               cpu_count=os.cpu_count())
    torch.cuda.empty_cache()

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    arr, lens = _pad([wdata[i * probe_n : (i + 1) * probe_n] for i in range(sms)], probe_n)
    x, l_gpu = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
    g = bwt_row_groups(sms, probe_n, x.device)
    u = torch.cat([bwt_forward_batch(x[s : s + g], l_gpu[s : s + g])[0]
                   for s in range(0, sms, g)])
    probe = {"shape": [sms, probe_n]}
    for k, rows in (("one", 1), ("sms", sms)):
        (pay, plens), probe[f"k1_{k}_ms"] = _timed(lambda: cm_cuda.cm_encode(u[:rows], l_gpu[:rows]))
        dec, probe[f"k2_{k}_ms"] = _timed(
            lambda: cm_cuda.cm_decode(pay, plens, l_gpu[:rows], probe_n))
        _require(torch.equal(dec, u[:rows]), f"K2(K1(u)) differs at [{rows}, {probe_n}]")
        if k == "one":
            first = pay[0, : int(plens[0])]
        else:
            _require(torch.equal(pay[0, : int(plens[0])], first),
                     "row 0's payload depends on the rows beside it")
        for kid in ("k1", "k2"):
            probe[f"{kid}_{k}_ns_per_bit_step"] = probe[f"{kid}_{k}_ms"] * 1e6 / (8 * probe_n)
    probe["k1_sms_over_one"] = probe["k1_sms_ms"] / probe["k1_one_ms"]
    probe["k2_sms_over_one"] = probe["k2_sms_ms"] / probe["k2_one_ms"]
    out["sm_probe"] = probe
    del x, u, dec, pay
    torch.cuda.empty_cache()
    emit(out)
    return out


def _sharded_run(card: str, run: str, data: bytes, bs: int, blocks: int, engine,
                 stream: bytes) -> dict:
    """One round trip of a sharded engine through the stream API: its
    stream must be ``stream`` (main's); one K1 and one K2 a share a wave;
    each share's K1 and K2 from CUDA events on its stream, and the
    overlap, the shares' kernel times summed over the stage's wall time
    (the share count for perfect overlap, 1.0 for none)."""
    _, got, out = _round_trip(card, "main_sharded", data, bs, blocks, engine=engine)
    _require(got == stream, f"main_sharded {run}: stream differs from main's")
    shares = len(engine.mesh)
    launches, calls = out["launches"], out["stage_calls"]
    _require({k for k, v in launches.items() if v} == set(DEFAULT_PATH), launches)
    _require(launches["cm_encode"] == shares * calls["encode/cm"]
             and launches["cm_decode"] == shares * calls["decode/cm"], (launches, calls))
    ms = engine.share_ms()
    out.update(run=run, mesh=[str(d) for d in engine.mesh], share_stages_ms=ms,
               share_k1_ms=[m["encode/cm"] for m in ms], share_k2_ms=[m["decode/cm"] for m in ms],
               timing="CUDA events on each share's stream around its stages")
    out["overlap_k1"] = sum(out["share_k1_ms"]) / (out["stages_s"]["encode/cm"] * 1e3)
    out["overlap_k2"] = sum(out["share_k2_ms"]) / (out["stages_s"]["decode/cm"] * 1e3)
    emit(out)
    return out


def phase_main_sharded(card: str, data: bytes, bs: int, blocks: int, stream: bytes,
                       host_crc_blocks: int = 4) -> dict:
    """The sharded engine on main's data at -b 16: through
    ``get_engine("sharded")`` (every card, one share on one card), then
    through two shares of one card (``mesh=["cuda:0", "cuda:0"]``: two
    threads, two streams, 4 rows each); each stream equal to main's, no
    row coded again.  Then ``host_crc=False`` (``BZ3_TPU_HOST_CRC=0``) on
    ``host_crc_blocks`` blocks of 1 MiB through the two shares, K4 inside
    each: its stream equal to the host CRC's; and ``python -m
    bzip3_tpu_torch -e --engine sharded`` on those blocks (files under
    ``_build/sharded/``), its blocks the same."""
    import torch
    from bzip3_tpu_torch.engines import DeviceEngine, get_engine

    with _env(BZ3_TPU_PROFILE="1"):
        one = get_engine("sharded")
    two = DeviceEngine("cuda", profile=True, mesh=["cuda:0", "cuda:0"])
    res = {"one_share": _sharded_run(card, "one_share", data, bs, blocks, one, stream),
           "two_shares": _sharded_run(card, "two_shares", data, bs, blocks, two, stream)}
    small, streams = data[: host_crc_blocks * MiB], {}
    for host_crc in ("1", "0"):
        with _env(BZ3_TPU_HOST_CRC=host_crc):
            eng = DeviceEngine("cuda", profile=True, mesh=["cuda:0", "cuda:0"])
            _, streams[host_crc], out = _round_trip(card, "main_sharded", small, MiB,
                                                    host_crc_blocks, engine=eng)
    _require(streams["0"] == streams["1"], "K4 inside the shares changed the stream")
    _require(out["launches"]["crc_lanes"] == 2 * out["stage_calls"]["encode/crc"], out)
    out.update(run="host_crc_off", mesh=["cuda:0", "cuda:0"], identical_to_host_crc=True)
    # the CLI's --engine sharded on the same data: the same blocks
    os.makedirs(SHARDED_DIR, exist_ok=True)
    src = os.path.join(SHARDED_DIR, "small")
    with open(src, "wb") as f:
        f.write(small)
    rc, cli_s, err = _cli("-e", "-b", "1", "-f", "--engine", "sharded", src, src + ".bz3")
    with open(src + ".bz3", "rb") as f:
        # the CLI without -j writes no trailing empty block; batches of 4 above do
        same = _chunks(f.read(), MiB) == _chunks(streams["1"], MiB)[:host_crc_blocks]
    _require(rc == 0 and same, f"--engine sharded -e: {rc} {err}")
    out["cli_engine_sharded"] = {"encode_s": cli_s, "identical_blocks": True}
    emit(out)
    res["host_crc_off"] = out
    torch.cuda.empty_cache()
    return res


MULTIHOST_DIR = os.path.join(ROOT, "_build", "multihost")
SHARDED_DIR = os.path.join(ROOT, "_build", "sharded")


def multihost_worker(job: str, out_prefix: str, bs: int, n: int, backend: str,
                     encode: bool) -> None:
    """One rank of phase_multihost, spawned with MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK: joins over ``backend`` ("default": the
    package's choice), codes its ``host_stripe`` of the ``n`` blocks of
    ``job`` on the card (or, without ``encode``, takes main's coded
    blocks), pads them to bound(bs) on the card and gathers them to rank
    0, which holds them against main's blocks; writes its result to
    ``out_prefix``.<rank>.json."""
    import pickle

    import torch
    from bzip3_tpu_torch.container.bound import bound
    from bzip3_tpu_torch.parallel import multihost as mh
    from bzip3_tpu_torch.parallel.sharding import sharded_pipeline
    from bzip3_tpu_torch.utils.profiling import StageTimer, device_sync

    mh.initialize(backend=None if backend == "default" else backend)
    dist = torch.distributed
    rank = dist.get_rank()
    with open(job, "rb") as f:
        want = pickle.load(f)
    stripe = list(mh.host_stripe(n))
    out = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend(),
           "stripe": stripe}
    reset_launches()
    if encode:
        mesh = mh.global_mesh()
        timer = StageTimer(enabled=True, sync=device_sync(mesh))
        t0 = time.perf_counter()
        coded = sharded_pipeline(bs, mesh, timer=timer).encode_blocks(
            [want["data"][i * bs : (i + 1) * bs] for i in stripe])
        out.update(encode_s=time.perf_counter() - t0, stages_s=dict(timer.totals),
                   launches=launch_counts())
    else:
        coded = [want["blocks"][i] for i in stripe]
    pad, lens = _pad(coded, bound(bs))
    rows, lens = torch.from_numpy(pad).cuda(), torch.from_numpy(lens).cuda()
    dist.barrier()
    t0 = time.perf_counter()
    got, got_lens = mh.gather_to_writer(rows, lens)
    out["gather_s"] = time.perf_counter() - t0
    if rank == 0:
        out["equal"] = [got[i, : got_lens[i]].tobytes() for i in range(n)] == want["blocks"][:n]
        out["gathered_bytes"] = int(got.nbytes)
    with open(f"{out_prefix}.{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _spawn(job: str, out_prefix: str, bs: int, n: int, backend: str, encode: bool,
           world: int, card_each: bool = False) -> list:
    """``world`` processes of multihost_worker, all on this card or with
    ``card_each`` rank r on card r alone (CUDA_VISIBLE_DEVICES)."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(world), "GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo",
           "PYTHONPATH": ROOT}
    code = (f"import chip_smoke; chip_smoke.multihost_worker({job!r}, {out_prefix!r}, {bs}, "
            f"{n}, {backend!r}, {encode})")
    return [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                             env={**env, "RANK": str(r),
                                  **({"CUDA_VISIBLE_DEVICES": str(r)} if card_each else {})},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _results(procs: list, out_prefix: str, backend: str, timeout: int = 300) -> list[dict]:
    """The results of _spawn's processes once they end; every one is
    stopped if one fails or the time runs out."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        _require(p.returncode == 0, f"{backend} rank {r} failed ({p.returncode}):\n{log[-4000:]}")
    res = []
    for r in range(len(procs)):
        with open(f"{out_prefix}.{r}.json") as f:
            res.append(json.load(f))
    return res


def phase_multihost(card: str, data: bytes, bs: int, stream: bytes, n: int = 4) -> dict:
    """The torch.distributed layer on the card: two processes over gloo
    on cuda:0 (NCCL refuses two ranks on one card), each coding its
    ``host_stripe`` of main's first ``n`` blocks, then ``gather_to_writer``
    assembling them on rank 0, equal to main's first ``n`` blocks; and at
    the same time one rank over NCCL (world size 1, the package's default
    backend on a card) gathering main's coded blocks as rows on the card."""
    import pickle

    import torch

    blocks = [b for _, b in _chunks(stream, bs)[:n]]
    os.makedirs(MULTIHOST_DIR, exist_ok=True)
    job = os.path.join(MULTIHOST_DIR, "job.pickle")
    with open(job, "wb") as f:
        pickle.dump({"data": data[: n * bs], "blocks": blocks}, f)
    torch.cuda.empty_cache()  # the ranks' own contexts share the card
    t0 = time.perf_counter()
    prefix = {b: os.path.join(MULTIHOST_DIR, b) for b in ("gloo", "nccl")}
    jobs = {"gloo": _spawn(job, prefix["gloo"], bs, n, "gloo", True, 2),
            "nccl": _spawn(job, prefix["nccl"], bs, n, "default", False, 1)}
    try:
        gloo = _results(jobs["gloo"], prefix["gloo"], "gloo")
        nccl = _results(jobs["nccl"], prefix["nccl"], "nccl")
    finally:
        for p in jobs["gloo"] + jobs["nccl"]:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    _require(gloo[0]["equal"], "the gloo ranks' gathered blocks differ from main's")
    _require([g["stripe"] for g in gloo] == [list(range(r, n, 2)) for r in range(2)], gloo)
    _require(all(g["launches"]["cm_encode"] == 1 for g in gloo), gloo)
    _require(nccl[0]["backend"] == "nccl" and nccl[0]["equal"], nccl)
    out = {"phase": "multihost", "card": card, "block_size": bs, "blocks": n, "gloo": gloo,
           "nccl": nccl, "wall_s": wall_s}
    emit(out)
    return out


def phase_dryrun(card: str) -> dict:
    """``dryrun_multichip(2, "cuda:0")``: the sharded encode and decode
    cores on two shares of the card at 4 rows of 512 bytes, K4 in each."""
    import torch
    from bzip3_tpu_torch.parallel.sharding import dryrun_multichip

    reset_launches()
    t0 = time.perf_counter()
    dryrun_multichip(2, "cuda:0")
    torch.cuda.synchronize()
    out = {"phase": "dryrun", "card": card, "n_devices": 2, "device": "cuda:0",
           "s": time.perf_counter() - t0, "launches": launch_counts()}
    _require(all(out["launches"][k] == 2 for k in ("cm_encode", "cm_decode", "crc_lanes")), out)
    emit(out)
    return out


SURFACE_DIR = os.path.join(ROOT, "_build", "surface")


def _chunks(stream: bytes, bs: int) -> list[tuple[int, bytes]]:
    """(orig_size, block bytes) of each block of a .bz3 stream."""
    from bzip3_tpu_torch.container.stream import iter_chunks

    return [(o, b) for _, o, b in iter_chunks(io.BytesIO(stream[9:]), bs)]


def _stream(bs: int, chunks: list[tuple[int, bytes]]) -> bytes:
    import struct

    return b"BZ3v1" + struct.pack("<I", bs) + b"".join(
        struct.pack("<II", len(b), o) + b for o, b in chunks)


def _cli(*args: str) -> tuple[int, float, str]:
    """(exit code, wall seconds, standard error) of ``python -m
    bzip3_tpu_torch`` with ``args``, run from the checkout's root."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "bzip3_tpu_torch", *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    return r.returncode, time.perf_counter() - t0, r.stderr[-2000:]


def _damage(chunks: list[tuple[int, bytes]], bs: int) -> tuple[list, int]:
    """Four of main's blocks, three damaged: block 1 with a payload byte
    flipped, block 2 with its stored CRC flipped, and block 3 (the first
    of main's blocks 3.. whose header has an LZP size) with that size set
    to bound(bs), past one 16 Mi-step launch.  (blocks, main's index of
    block 3)"""
    import struct
    from bzip3_tpu_torch.container.bound import bound
    from bzip3_tpu_torch.models.block_codec import parse_block_header

    j = next((i for i in range(3, len(chunks))
              if parse_block_header(chunks[i][1]).model & 2), None)
    _require(j is not None, "no block of main's stream has an LZP size to damage")
    out = [chunks[0], chunks[1], chunks[2], chunks[j]]
    b = bytearray(out[1][1])
    b[len(b) // 2] ^= 0xFF
    out[1] = (out[1][0], bytes(b))
    b = bytearray(out[2][1])
    b[0] ^= 0x01
    out[2] = (out[2][0], bytes(b))
    b = bytearray(out[3][1])
    struct.pack_into("<i", b, 9, bound(bs))
    out[3] = (out[3][0], bytes(b))
    return out, j


def phase_surface(card: str, data: bytes, bs: int, blocks: int, stream: bytes) -> dict:
    """The public surface around the main path, at -b 16 on main's data
    and stream (``stream``): the block API (``Bz3Codec`` on one block,
    K1, K2 and K4 one row a launch), test mode (``test_file``, and
    ``python -m bzip3_tpu_torch -t`` on the stream and on a damaged one),
    recover mode (``recover_file`` on four blocks, three damaged: the
    damaged header's block goes through K3b), and the native and hybrid
    engines.  Every stream equals main's, and each damaged block's
    best-effort bytes equal the same chain run by the host C++
    (``ops.native.STAGES``: host CM decode, inverse BWT, un-LZP, un-RLE)."""
    import contextlib
    import torch
    from bzip3_tpu_torch import Bz3Codec, recover_file, test_file
    from bzip3_tpu_torch.engines import DeviceEngine, HybridEngine, NativeEngine
    from bzip3_tpu_torch.models.block_codec import decode_block_recover
    from bzip3_tpu_torch.ops import native

    t_phase = time.perf_counter()
    # main's stream ends in an empty block (an exact multiple of bs at -j 8)
    chunks = _chunks(stream, bs)[:blocks]
    _require([o for o, _ in chunks] == [bs] * blocks, [o for o, _ in chunks])
    os.makedirs(SURFACE_DIR, exist_ok=True)
    out = {"phase": "surface", "card": card, "block_size": bs}
    reset_launches()

    # block API: one block through Bz3Codec, stage by stage on the card
    codec = Bz3Codec(bs, device="cuda")
    with _LaunchTimes("bz3t_cm_encode", "bz3t_cm_decode", "bz3t_crc_lanes") as lt:
        t0 = time.perf_counter()
        blk = codec.encode_block(data[:bs])
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = codec.decode_block(blk, bs)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        one_row = {k: lt.ms(f"bz3t_{k}") for k in ("cm_encode", "cm_decode", "crc_lanes")}
    _require(blk == chunks[0][1], "Bz3Codec's block differs from main's")
    _require(back == data[:bs], "Bz3Codec's decode differs from the input")
    out["block_api"] = {
        "encode_s": enc_s, "decode_s": dec_s, "launches": launch_counts(),
        "k1_one_row_ms": one_row["cm_encode"][0], "k2_one_row_ms": one_row["cm_decode"][0],
        # K4 on an idle card: each launch's time includes the host's call
        "k4_one_row_ms": one_row["crc_lanes"][0] / max(1, one_row["crc_lanes"][1]),
        "k4_launches": one_row["crc_lanes"][1],
        "k1_ns_per_bit_step": one_row["cm_encode"][0] * 1e6 / (8 * bs)}

    # test mode: the library call, then the CLI on main's stream and on a
    # damaged one
    eng = DeviceEngine("cuda")
    t0 = time.perf_counter()
    rw = test_file(io.BytesIO(stream), eng, batch_size=blocks)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    _require(rw == (len(stream), len(data)), rw)
    bad, j = _damage(chunks, bs)
    good_path = os.path.join(SURFACE_DIR, "main.bz3")
    bad_path = os.path.join(SURFACE_DIR, "damaged.bz3")
    with open(good_path, "wb") as f:
        f.write(stream)
    bad_stream = _stream(bs, bad)
    with open(bad_path, "wb") as f:
        f.write(bad_stream)
    rc_good, cli_good_s, err = _cli("-t", good_path)
    _require(rc_good == 0, f"-t on main's stream: rc {rc_good}: {err}")
    rc_bad, cli_bad_s, err = _cli("-t", bad_path)
    _require(rc_bad == 1, f"-t on the damaged stream: rc {rc_bad}: {err}")
    out["test"] = {"test_file_s": test_s, "cli_t_s": cli_good_s, "cli_t_damaged_s": cli_bad_s,
                   "cli_t_rc": rc_good, "cli_t_damaged_rc": rc_bad}

    # recover mode on the card, against the host C++ chain
    src = [data[:bs], data[bs : 2 * bs], data[2 * bs : 3 * bs], data[j * bs : (j + 1) * bs]]
    before = launch_counts()
    err = io.StringIO()
    rec = io.BytesIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rw = recover_file(io.BytesIO(bad_stream), rec, eng, batch_size=4)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    got = rec.getvalue()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    _require(rw == (len(bad_stream), 4 * bs), rw)
    _require(len(got) == 4 * bs, len(got))
    pieces = [got[i * bs : (i + 1) * bs] for i in range(4)]
    _require(pieces[0] == src[0] and pieces[2] == src[2],
             "recover: the intact or the CRC-flipped block differs from the source")
    t0 = time.perf_counter()
    host = [decode_block_recover(b, o, bs, native.STAGES) for o, b in (bad[1], bad[3])]
    host_s = time.perf_counter() - t0
    _require(all(not ok for _, ok in host), "a damaged block decoded on the host")
    diff = [int(np.count_nonzero(np.frombuffer(pieces[i], np.uint8) != np.frombuffer(h, np.uint8)))
            for i, (h, _) in zip((1, 3), host)]
    _require(diff == [0, 0], f"recover: best-effort bytes differ from the host chain: {diff}")
    _require(launches["cm_decode_resume"] > 0, f"recover launched no K3b: {launches}")
    warns = err.getvalue().count("bzip3: Writing invalid block.")
    _require(warns == 3, f"{warns} 'Writing invalid block.' lines, not 3")
    out["recover"] = {
        "blocks": 4, "damaged_header_block_of_main": j, "recover_s": rec_s,
        "host_chain_s": host_s, "launches": launches, "invalid_block_lines": warns,
        "best_effort_bytes_equal_to_source": [pieces[i] == src[i] for i in (1, 3)]}

    # native (2 blocks) and hybrid (all, half on the card) engines
    mib = lambda n, s: n / MiB / s  # noqa: E731
    nat = NativeEngine(0)
    t0 = time.perf_counter()
    nb = nat.encode_blocks([data[:bs], data[bs : 2 * bs]], bs)
    n_enc = time.perf_counter() - t0
    _require(nb == [chunks[0][1], chunks[1][1]], "native blocks differ from main's")
    t0 = time.perf_counter()
    nd = nat.decode_blocks([(b, bs) for b in nb], bs)
    n_dec = time.perf_counter() - t0
    _require(nd == [data[:bs], data[bs : 2 * bs]], "native decode differs")
    os.environ["BZ3_TPU_HYBRID_MIN_MIB"] = "0"
    try:
        hyb = HybridEngine(0, device_share=0.5, device="cuda")
        raw = [data[i * bs : (i + 1) * bs] for i in range(blocks)]
        before = launch_counts()
        t0 = time.perf_counter()
        hb = hyb.encode_blocks(raw, bs)
        torch.cuda.synchronize()
        h_enc = time.perf_counter() - t0
        _require(hb == [b for _, b in chunks], "hybrid blocks differ from main's")
        t0 = time.perf_counter()
        hd = hyb.decode_blocks([(b, bs) for b in hb], bs)
        torch.cuda.synchronize()
        h_dec = time.perf_counter() - t0
        _require(hd == raw, "hybrid decode differs")
        h_launch = {k: v - before[k] for k, v in launch_counts().items()}
        _require(h_launch["cm_encode"] > 0 and h_launch["cm_decode"] > 0,
                 f"the hybrid's device share launched no K1/K2: {h_launch}")
    finally:
        del os.environ["BZ3_TPU_HYBRID_MIN_MIB"]
    out["engines"] = {
        "host_cores": os.cpu_count(), "host_cores_usable": len(os.sched_getaffinity(0)),
        "native_blocks": 2, "native_encode_mib_s": mib(2 * bs, n_enc),
        "native_decode_mib_s": mib(2 * bs, n_dec),
        "hybrid_blocks": blocks, "hybrid_share": 0.5, "hybrid_launches": h_launch,
        "hybrid_encode_mib_s": mib(blocks * bs, h_enc),
        "hybrid_decode_mib_s": mib(blocks * bs, h_dec)}
    out["launches"] = launch_counts()
    _require(all(out["launches"][k] for k in SURFACE_PATH), out["launches"])
    out["phase_s"] = time.perf_counter() - t_phase

    # K4 on one 16 MiB row again, queued behind a sleeping kernel, so that
    # the host's time to launch it is off the card's clock (the block
    # API's launches ran on an idle card); after the counts are read
    from bzip3_tpu_torch.ops.device import crc32_cuda

    row = torch.frombuffer(bytearray(data[:bs]), dtype=torch.uint8).view(1, bs).cuda()
    lens = torch.tensor([bs], dtype=torch.int32, device=row.device)
    lanes = crc32_cuda.lanes_for(row)
    out["block_api"].update(
        k4_one_row_lanes=lanes,
        k4_one_row_queued_ms=_cuda_ms(lambda: crc32_cuda.crc_lane_scan(row, lens, lanes), 20,
                                      queue=True))
    emit(out)
    return out


HARDEN_DIR = os.path.join(ROOT, "_build", "harden")
EXAMPLES = os.path.join(ROOT, "examples")
HARDEN_SEED = 13
ORACLE_MIN_BLOCKS = 16  # compressed blocks the oracle leg must hold
# the kernels the harden phase must launch (K3c: the forced hybrid)
HARDEN_PATH = ("cm_encode", "cm_decode", "cm_encode_resume", "cm_decode_resume",
               "cm_decode_stream", "crc_lanes", "lzp_encode", "lzp_decode", "chain_windows",
               "range_pass")
# the size before the BWT given to harden's damaged wide block: past one
# launch of 16 Mi steps, so that K3b decodes it in two
WIDE_SBB = (16 << 20) + 4096


def _wrapper(name: str, args: list[str], stdout) -> subprocess.Popen:
    """``bin/torch/<name> args`` on the card (the CLI's default engine and
    device), its output to ``stdout``."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "BZ3_ENGINE",
                                                             "BZ3_DEVICE")}
    env.update(PYTHONPATH=ROOT,
               PATH=os.path.dirname(sys.executable) + os.pathsep + env.get("PATH", ""))
    return subprocess.Popen(["sh", os.path.join(ROOT, "bin", "torch", name), *args], cwd=ROOT,
                            env=env, stdout=stdout, stderr=subprocess.PIPE)


def _wide_damaged(chunks: list[tuple[int, bytes]]) -> tuple[bytes, int]:
    """Main's first block whose header has an LZP or RLE size, with that
    size (the size before the BWT) set to ``WIDE_SBB`` and the middle byte
    of its payload flipped: (block, orig_size)."""
    import struct
    from bzip3_tpu_torch.models.block_codec import parse_block_header

    j = next((i for i, (_, b) in enumerate(chunks) if parse_block_header(b).model & 6), None)
    _require(j is not None, "no block of main's stream has an LZP or RLE size")
    b = bytearray(chunks[j][1])
    hdr = parse_block_header(bytes(b))
    struct.pack_into("<i", b, 9, WIDE_SBB)  # the LZP size, else the RLE size
    mid = hdr.header_size() + (len(b) - hdr.header_size()) // 2
    b[mid] ^= 0x10
    return bytes(b), chunks[j][0]


def phase_harden(card: str, data: bytes, bs: int, blocks: int, stream: bytes) -> dict:
    """The port's hardening harnesses (``examples/torch_*.py``) on the card,
    with the same seeds every run, each outcome held to the native engine
    (the same bytes, or the same error code as the pipeline over the host
    coder and an error from the native engine too) and a synchronise after
    each batch:

    a. ``torch_differential_engines``: 20 trials (1-4 blocks of 66,560 or
       131,072 bytes) over the default, device-prepass and parallel routes,
       encode and decode; its oracle leg encodes and decodes every block of
       them, whole, through the oracle engine (``ops/ref``) on
       ``OracleLeg.WORKERS`` spawned processes while the card runs the rest
       of the phase, checked after ``e``, and its plain leg the blocks of
       CM rows up to 64 bytes through the plain versions;
       ``torch_fuzz_round_trip`` on 40 inputs through the device engine;
    b. ``torch_fuzz_decode_block``: 400 of the JAX harness's damaged blocks
       and the aimed cases through ``Bz3Codec.decode_block``, then in
       batches of 1-8 through the default and the device-prepass
       ``DeviceEngine`` (K6 on malformed LZP streams) and
    e. through the host-BWT hybrid forced at 65 KiB (K3a on the intact
       blocks, K3c on the damaged rows);
    c. ``torch_fuzz_decompress``: 200 damaged frames with ``max_output``;
    d. one of main's blocks with its size before the BWT set past 16 Mi
       steps and a payload byte flipped, decoded on the wave path at a
       block size of 17 MiB: K3b on a damaged payload, its decoded row
       equal in full to the host coder's decode of the same payload;

    then a ``torch.cuda.synchronize()`` and main's first block round-tripped
    through a fresh ``DeviceEngine``, equal to main's stream: the context
    survived.  ``bin/torch/bz3cat`` and ``bz3grep`` run once on main's
    stream meanwhile, in processes of their own."""
    import torch

    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    import torch_differential_engines as de
    import torch_fuzz_decode_block as fdb
    import torch_fuzz_decompress as fdc
    import torch_fuzz_round_trip as frt
    from torch_harness import HarnessFailure, ReferenceEngine, check_batch
    from bzip3_tpu_torch.engines import DeviceEngine, NativeEngine
    from bzip3_tpu_torch.models.block_codec import parse_block_header
    from bzip3_tpu_torch.ops import native
    from bzip3_tpu_torch.ops.device import cm_cuda

    t_phase = time.perf_counter()
    os.makedirs(HARDEN_DIR, exist_ok=True)
    main_path = os.path.join(HARDEN_DIR, "main.bz3")
    with open(main_path, "wb") as f:
        f.write(stream)
    cat_path = os.path.join(HARDEN_DIR, "bz3cat.out")
    grep_pat = b"<page>"
    with open(cat_path, "wb") as cat_out:
        procs = {"bz3cat": _wrapper("bz3cat", [main_path], cat_out),
                 "bz3grep": _wrapper("bz3grep", ["-o", "-F", "-e", grep_pat.decode(), main_path],
                                     subprocess.PIPE)}
    out = {"phase": "harden", "card": card, "seed": HARDEN_SEED}
    quiet = lambda *a: None  # noqa: E731
    parts = {}

    def part(name, fn):
        before = launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        res["s"] = time.perf_counter() - t0
        res["launches"] = {k: v - before[k] for k, v in launch_counts().items() if v - before[k]}
        parts[name] = res

    def wide():
        blk, orig = _wide_damaged(_chunks(stream, bs)[:blocks])
        rows, decode = [], cm_cuda.cm_decode

        def keep(*a, **kw):  # the wave path's CM decode, its wide row kept
            u = decode(*a, **kw)
            if u.shape[1] >= WIDE_SBB:
                rows.append(u[0, :WIDE_SBB].cpu().numpy().tobytes())
            return u

        cm_cuda.cm_decode = keep
        try:
            got = check_batch(HARDEN_SEED, "wide", [(blk, orig)], 17 * MiB, DeviceEngine("cuda"),
                              ReferenceEngine(device="cuda"), NativeEngine(0), "cuda")
        finally:
            cm_cuda.cm_decode = decode
        _require(len(rows) == 1, f"harden: the wave path decoded {len(rows)} wide rows")
        want = native.cm_decode(blk[parse_block_header(blk).header_size() :], WIDE_SBB)
        diff = np.flatnonzero(np.frombuffer(rows[0], np.uint8) != np.frombuffer(want, np.uint8))
        _require(diff.size == 0, f"harden: K3b's decode of the damaged wide block differs from "
                 f"the host coder's at {diff.size} of {WIDE_SBB} steps, first {diff[:1]}")
        return {"outcome": got[1] if got[0] == "err" else "ok", "sbb": WIDE_SBB,
                "k3b_row_equal_host_coder": True}

    reset_launches()
    leg = de.OracleLeg()
    try:  # the wrappers and the oracle's workers are stopped whatever fails
        part("differential", lambda: de.run(HARDEN_SEED, 20, "cuda", plain_row=64, log=quiet,
                                            leg=leg))
        part("round_trip", lambda: frt.run(HARDEN_SEED, 40, "device", "cuda", log=quiet))
        part("decode_block", lambda: fdb.run(HARDEN_SEED, 400, "cuda", log=quiet))
        part("decompress", lambda: fdc.run(HARDEN_SEED, 200, "cuda", log=quiet))
        part("wide", wide)
        oracle = leg.finish()
        emit({"phase": "harden_oracle", "card": card, "seed": HARDEN_SEED,
              "mismatches": oracle["blocks"] - oracle["equal"], **oracle})
        _require(oracle["compressed_blocks"] >= ORACLE_MIN_BLOCKS,
                 f"harden: the oracle held {oracle['compressed_blocks']} compressed blocks, "
                 f"fewer than {ORACLE_MIN_BLOCKS}")
        torch.cuda.synchronize()
        eng = DeviceEngine("cuda")
        first = eng.encode_blocks([data[:bs]], bs)[0]
        _require(first == _chunks(stream, bs)[0][1], "harden: main's first block differs after "
                 "the harnesses")
        _require(eng.decode_blocks([(first, bs)], bs)[0] == data[:bs],
                 "harden: main's first block does not round-trip after the harnesses")
        torch.cuda.synchronize()
        grep_out, grep_err = procs["bz3grep"].communicate(timeout=600)
        procs["bz3cat"].wait(timeout=600)
    except HarnessFailure as e:
        _require(False, f"harden: {e}")
    finally:
        leg.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    _require(procs["bz3cat"].returncode == 0,
             f"bin/torch/bz3cat: rc {procs['bz3cat'].returncode}: "
             f"{procs['bz3cat'].stderr.read()[-2000:]}")
    _require(procs["bz3grep"].returncode == 0,
             f"bin/torch/bz3grep: rc {procs['bz3grep'].returncode}: {grep_err[-2000:]}")
    with open(cat_path, "rb") as f:
        _require(f.read() == data, "bin/torch/bz3cat's output differs from main's data")
    hits = grep_out.count(b"\n")
    _require(hits == data.count(grep_pat), f"bin/torch/bz3grep: {hits} matches against "
             f"{data.count(grep_pat)}")
    os.remove(cat_path)
    out["parts"] = parts
    out["oracle"] = oracle
    out["trials"] = {"differential_trials": 20, "differential_routes": list(de.ROUTES),
                     "oracle_blocks": oracle["blocks"], "round_trip_inputs": 40,
                     "blocks": parts["decode_block"]["blocks"],
                     "frames": parts["decompress"]["frames"], "wide_blocks": 1}
    codes: dict = {}
    for res in (parts["decode_block"]["outcomes"], parts["decompress"]["outcomes"],
                *parts["decode_block"]["batches"].values(), {parts["wide"]["outcome"]: 1}):
        for k, v in res.items():
            codes[str(k)] = codes.get(str(k), 0) + v
    out["outcomes"] = codes
    out["wrappers"] = {"bz3cat_bytes": len(data), "bz3grep_matches": hits}
    out["launches"] = launch_counts()
    _require(all(out["launches"][k] for k in HARDEN_PATH),
             f"harden launched no {[k for k in HARDEN_PATH if not out['launches'][k]]}")
    _require(parts["wide"]["launches"].get("cm_decode_resume", 0) >= 2,
             f"the wide block ran no K3b launches: {parts['wide']['launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _resume_rows(parity: dict, resume: dict, b32: dict, over: dict, wide: dict) -> list[dict]:
    """K3a-K3c: times at [2, 32 Mi] (K3a, K3b; main_b32's own launches)
    and at the oversize row (K3c), launches from those phases; K3a's and
    K3b's times and launches at main_wide's rows beside.  Beside the
    contract's bound: the serial bound (the longest row's bit steps at
    K1's or K2's measured step latency) and the state spill, each launch
    after the first loading and each launch before the last storing the
    rows' tables and registers."""
    from bzip3_tpu_torch.ops.device.launch import I64, entry

    state = entry("bz3t_cm_state_bytes", [], I64)()
    ns = parity["k2_k1_1MiB"]
    # each held against its plain version at the main paths' shapes too
    prefix_err = {"K3a": over["k3a_prefix_max_abs_err"], "K3b": b32["k3b_prefix_max_abs_err"],
                  "K3c": over["k3c_prefix_max_abs_err"]}
    rows = []
    for kid, key, fn, replaces, ph, ins, outs, ns_bit, ns_k3 in (
        ("K3a", "cm_encode_resume", "cm_encode_resume_kernel",
         "bzip3_tpu/ops/device/cm_pallas.py:1883", b32, b32["row_lens"], b32["payload_lens"],
         ns["k1_ns_per_bit"], b32["ns_per_bit_step"]["k3a"]),
        ("K3b", "cm_decode_resume", "cm_decode_resume_kernel",
         "bzip3_tpu/ops/device/cm_pallas.py:1029", b32, b32["payload_lens"], b32["row_lens"],
         ns["k2_ns_per_bit"], b32["ns_per_bit_step"]["k3b"]),
        ("K3c", "cm_decode_stream", "cm_decode_resume_kernel (out_rel)",
         "bzip3_tpu/ops/device/cm_pallas.py:1100", over, [over["payload_len"]],
         [over["post_prepass_len"]], ns["k2_ns_per_bit"], over["ns_per_bit_step"]["k3c"]),
    ):
        k = kid.lower()
        steps = outs if kid != "K3a" else ins
        launches = ph["launches"][key]
        bound_ms, bound_by = _bound(sum(ins) + sum(outs) + 8 * len(ins),
                                    OPS_PER_BIT * 8 * sum(steps))
        spill = 2 * (launches - 1) * len(ins) * state
        rows.append({
            "name": f"{kid} {fn}", "route": "cuda",
            "source": "bzip3_tpu_torch/csrc/cm_kernels.cu", "replaces": replaces,
            "status": STATUS[kid],
            "launches": launches,
            "max_abs_err": max(resume[k]["max_abs_err"], prefix_err[kid]),
            "ms": ph[f"{k}_ms"], "plain_ms": resume[k]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": [len(ins), max(steps)],
            "plain_shape": [resume["rows"], resume["width"]],
            "plain_device": resume[k]["plain_device"],
            "kernel_ms_at_plain_shape": resume[k]["ms"],
            "serial_bound_ms": 8 * max(steps) * ns_bit * 1e-6,
            "ns_per_bit_step": ns_k3,
            "spill_bytes": spill, "spill_bound_ms": spill / PEAK_BYTES_PER_S * 1e3,
        })
    # at main_wide's rows on the wave path: times, launches and bounds
    pays = wide["payload_lens"]
    for row, k, key, ns_bit in zip(rows, ("k3a", "k3b"), B32_PATH,
                                   (ns["k1_ns_per_bit"], ns["k2_ns_per_bit"])):
        lens = wide["row_lens"]
        bound_ms, bound_by = _bound(sum(lens) + sum(pays) + 8 * len(lens),
                                    OPS_PER_BIT * 8 * sum(lens))
        row.update({"launches_main_wide": wide["launches"][key], "ms_main_wide": wide[f"{k}_ms"],
                    "shape_main_wide": [wide["blocks"], wide["width"]],
                    "ns_per_bit_step_main_wide": wide["ns_per_bit_step"][k],
                    "bound_ms_main_wide": bound_ms, "bound_by_main_wide": bound_by,
                    "serial_bound_ms_main_wide": 8 * max(lens) * ns_bit * 1e-6})
    rows[0]["launches_oversize"] = over["launches"]["cm_encode_resume"]
    rows[0]["ms_oversize"] = over["k3a_ms"]
    rows[0]["ns_per_bit_step_oversize"] = over["ns_per_bit_step"]["k3a"]
    return rows


def _parallel_rows(ppar: dict, mpar: dict, resources: dict) -> list[dict]:
    """P1 and P2: launches, times and bounds from main_parallel's own
    launches (all of P1's passes summed), errors the larger of
    parity_parallel's and main_parallel's (at the main shape), plain
    times from parity_parallel (P1's: one pass a mode at seg 2048)."""
    rows = []
    for kid, fn, src_line in (
        ("P1", "chain_windows_kernel", "bzip3_tpu/ops/device/cm_parallel.py:137"),
        ("P2", "range_pass_kernel", "bzip3_tpu/ops/device/cm_parallel.py:349"),
    ):
        k, m = kid.lower(), mpar[kid.lower()]
        par = ppar[k]
        row = {
            "name": f"{kid} {fn}", "route": "cuda",
            "source": "bzip3_tpu_torch/csrc/cm_parallel_kernels.cu", "replaces": src_line,
            "status": STATUS[kid], "launches": m["launches"],
            "max_abs_err": max(par["max_abs_err"], m["max_abs_err"]),
            "ms": m["ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "shape": [mpar["blocks"], max(mpar["row_lens"])],
            "plain_device": "cpu", "registers": resources.get(fn, {}).get("registers"),
        }
        if kid == "P1":
            row.update({"plain_ms": sum(v["plain_ms"] for v in par["modes"].values()),
                        "kernel_ms_at_plain_shape": sum(v["ms"] for v in par["modes"].values()),
                        "plain_shape": "one pass a mode and rate at seg 2048 (parity_parallel)",
                        "by_mode": m["by_mode"]})
        else:
            row.update({"plain_ms": par["plain_ms"], "kernel_ms_at_plain_shape": par["ms"],
                        "plain_shape": [ppar["rows"], ppar["width"]],
                        "serial_bound_ms": m["serial_bound_ms"],
                        "ns_per_bit_step": m["ms"] * 1e6 / (8 * max(mpar["row_lens"]))})
        rows.append(row)
    return rows


def kernels_line(parity: dict, main: dict, shapes: dict, pparity: dict, pmain: dict,
                 pshapes: dict, resume: dict, b32: dict, over: dict, resources: dict,
                 surface: dict, ppar: dict, mpar: dict, wave: dict, wide: dict,
                 harden: dict) -> dict:
    """The kernels of the main paths: launches from the main phases
    (K1/K2 from the default path, K4-K6 from the device prepass chain,
    K3a-K3c from main_b32 and main_oversize, P1/P2 from main_parallel),
    times at their rows, plain times from the parity phases (the plain CM
    coder takes ~0.1 ms a bit step: hours at 16 MiB)."""
    ins, pays = shapes["row_lens"], shapes["payload_lens"]
    rows = []
    for kid, key, fn, src_line in (
        ("K1", "cm_encode", "cm_encode_kernel", "bzip3_tpu/ops/device/cm_pallas.py:1379"),
        ("K2", "cm_decode", "cm_decode_kernel", "bzip3_tpu/ops/device/cm_pallas.py:450"),
    ):
        k = kid.lower()
        # each input byte read once and each output byte written once,
        # plus the [K] length vectors; operations per coded bit
        bound_ms, bound_by = _bound(sum(ins) + sum(pays) + 8 * len(ins),
                                    OPS_PER_BIT * 8 * sum(ins))
        ns_bit = parity["k2_k1_1MiB"][f"{k}_ns_per_bit"]
        rows.append({
            "name": f"{kid} {fn}", "route": "cuda",
            "source": "bzip3_tpu_torch/csrc/cm_kernels.cu", "replaces": src_line,
            "status": STATUS[kid],
            "launches": main["launches"][key],
            "max_abs_err": max(parity[k]["max_abs_err"], shapes[f"{k}_prefix_max_abs_err"]),
            "ms": shapes[f"{k}_ms"], "plain_ms": parity[k]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": shapes["shape"],
            "plain_shape": [parity["rows"], parity["width"]],
            "plain_device": parity[k]["plain_device"],
            "kernel_ms_at_plain_shape": parity[k]["ms"],
            "serial_bound_ms": 8 * max(ins) * ns_bit * 1e-6,
            "ns_per_bit_step": ns_bit,
        })

    k_rows, raw = pshapes["shape"][0], pshapes["row_lens"]
    mid = pshapes["post_rle_lens"]
    dec_out = [mid[i] for i in range(k_rows) if pshapes["lzp_lens"][i] >= 0]
    for kid, key, fn, src, src_line, nbytes, ops in (
        # K4: every byte read once, [K, L] int32 lane states written (L
        # from crc32.kernel_lanes: one CTA a lane)
        ("K4", "crc_lanes", "crc_lane_kernel", "crc32_kernels.cu",
         "bzip3_tpu/ops/device/crc32_pallas.py:45",
         sum(raw) + 4 * k_rows * pshapes["lanes"] + 4 * k_rows, OPS_PER_CRC_BYTE * sum(raw)),
        # K5: post-RLE rows read, LZP streams written; one step a byte
        ("K5", "lzp_encode", "lzp_encode_kernel", "lzp_kernels.cu",
         "bzip3_tpu/ops/device/lzp_pallas.py:135", pshapes["k5_bytes"],
         OPS_PER_LZP_STEP * sum(mid)),
        # K6: the LZP streams read, the rows they came from written
        ("K6", "lzp_decode", "lzp_decode_kernel", "lzp_kernels.cu",
         "bzip3_tpu/ops/device/lzp_pallas.py:285", pshapes["k6_bytes"],
         OPS_PER_LZP_STEP * sum(dec_out)),
    ):
        k = kid.lower()
        bound_ms, bound_by = _bound(nbytes, ops)
        row = {
            "name": f"{kid} {fn}", "route": "cuda",
            "source": f"bzip3_tpu_torch/csrc/{src}", "replaces": src_line,
            "status": STATUS[kid],
            "launches": pmain["launches"][key],
            "max_abs_err": pparity[k]["max_abs_err"],
            "ms": pshapes[f"{k}_ms"], "plain_ms": pparity[k]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": pshapes["shape"],
            "plain_shape": pparity[k]["shape"],
            "plain_device": pparity[k]["plain_device"],
            "kernel_ms_at_plain_shape": pparity[k]["ms"],
            "ns_per_step_one_row": pparity[k]["step_ns"],
            "registers": resources.get(fn, {}).get("registers"),
        }
        if kid == "K4":  # a lane's bytes at one CTA's own rate, alone on the card
            row.update({"serial_bound_ms": pshapes["seg"] * pparity["k4"]["step_ns"] * 1e-6,
                        "lanes": pshapes["lanes"], "smem_bytes": pshapes["k4_smem_bytes"]})
        else:  # the busiest row's counted windows at the L2 round trip
            st = pshapes[f"{k}_stats"]["per_row"]
            busiest = max(range(k_rows), key=lambda i: st[i][0])
            row.update({"latency_bound_ms": pshapes[f"{k}_latency_bound_ms"],
                        "l2_round_trip_ns": pshapes["l2_round_trip_ns"],
                        "busiest_row": dict(zip(pshapes[f"{k}_stats"]["cols"], st[busiest]))})
        rows.append(row)
    rows[2:2] = _resume_rows(parity, resume, b32, over, wide)
    # the surface phase's launches (its own path), and K1/K2/K4 at one row
    one = surface["block_api"]
    for row in rows:
        kid = row["name"].split()[0]
        key = {"K1": "cm_encode", "K2": "cm_decode", "K3b": "cm_decode_resume",
               "K4": "crc_lanes"}.get(kid)
        if key is not None:
            row["launches_surface"] = surface["launches"][key]
        if kid in ("K1", "K2"):
            row["ms_one_row"] = one[f"{kid.lower()}_one_row_ms"]
            row["launches_main_wave"] = wave["launches"][key]
            row["ms_sms_rows_over_one"] = wave["sm_probe"][f"{kid.lower()}_sms_over_one"]
        if kid == "K4":
            row["ms_one_row"] = one["k4_one_row_queued_ms"]
            row["ms_one_row_idle_card"] = one["k4_one_row_ms"]
    rows += _parallel_rows(ppar, mpar, resources)
    # the harden phase's launches, damaged and random input (every kernel)
    keys = {"K1": "cm_encode", "K2": "cm_decode", "K3a": "cm_encode_resume",
            "K3b": "cm_decode_resume", "K3c": "cm_decode_stream", "K4": "crc_lanes",
            "K5": "lzp_encode", "K6": "lzp_decode", "P1": "chain_windows", "P2": "range_pass"}
    for row in rows:
        row["launches_harden"] = harden["launches"][keys[row["name"].split()[0]]]
    return {"kernels": rows}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "bzip3_tpu_torch")):
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card is needed",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase_device(smi)
    built = phase_build(smi)
    lat = phase_latency(smi)
    parity = phase_parity(smi)
    pparity = phase_parity_prepass(smi)
    phase_golden(smi)
    bs, blocks = 16 * MiB, 8
    data = corpus(blocks * bs, seed=0)
    main_res, main_stream = phase_main(smi, data, bs, blocks)
    shapes = phase_main_shapes(smi, data, bs, blocks)
    surface = phase_surface(smi, data, bs, blocks, main_stream)
    harden = phase_harden(smi, data, bs, blocks, main_stream)
    # 4 text blocks, 3 of log lines, 1 sparse: LZP and RLE both kept
    pdata = data[: 4 * bs] + log_corpus(3 * bs, seed=1) + sparse_block(bs, seed=2)
    pmain, pstream = phase_main_prepass(smi, pdata, bs, blocks)
    pshapes = phase_prepass_shapes(smi, pdata, bs, blocks, lat)
    fresh = corpus(16 * bs, seed=3)
    wave = phase_main_wave(smi, data, pdata, fresh, main_stream, pstream, bs)
    resume = phase_parity_resume(smi)
    log = pdata[4 * bs : 7 * bs]  # 48 MiB of log lines
    b32 = phase_main_b32(smi, data[: 2 * bs] + log[: 2 * bs])
    # one 40 MiB block of text and log lines (LZP kept) past a cap of 32 MiB
    over = phase_main_oversize(smi, data[: 24 * MiB] + log[: 16 * MiB], b32)
    pool = wide_pool(data, pdata, fresh, bs)
    wide_data = wide_blocks(pool, 4, 9)
    wide, wide_stream = phase_main_wide(smi, wide_data, 144 * MiB, over)
    phase_main_wide_prepass(smi, wide_data, 144 * MiB, wide, wide_stream)
    del wide_data, wide_stream
    phase_wide_bwt(smi, pool)
    ppar = phase_parity_parallel(smi)
    mpar = phase_main_parallel(smi, data[: 16 * 2 * MiB], parity, lat)
    phase_main_sharded(smi, data, bs, blocks, main_stream)
    phase_multihost(smi, data, bs, main_stream)
    phase_dryrun(smi)
    emit(kernels_line(parity, main_res, shapes, pparity, pmain, pshapes, resume, b32, over,
                      built["resources"], surface, ppar, mpar, wave, wide, harden))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
