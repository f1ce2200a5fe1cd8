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
7. parity_prepass - K4 (CRC lane scan), K5 (LZP encode) and K6 (LZP
             decode) against their plain versions on CPU copies of the
             same rows of <= 4 KiB, byte for byte, K4's CRCs against the
             host C++, and each kernel's step latency on one row;
8. main_prepass - the device prepass chain: 8 blocks x 16 MiB (text,
             log lines where LZP fires, a sparse block where RLE fires)
             through ``compress_file`` / ``decompress_file`` with
             ``device_prepass=True``; the stream must equal the default
             path's, with LZP and RLE each kept on some block;
9. prepass_shapes - K4, K5 and K6 on that phase's own [8, 16 Mi] rows,
             timed, each checked in full against the host C++;
10. parity_resume - K3a, K3b and K3c (the resumable CM kernels) against
             their plain versions on CPU copies of the same rows, in
             launches of 256 steps, byte for byte, and against K1/K2;
11. main_b32 - the device path at -b 32: a text block and a log block
             of 32 MiB through ``compress_file`` / ``decompress_file``,
             CM-coded by K3a/K3b in two launches of 16 Mi steps, each
             launch timed with CUDA events as it runs; then K1 in one
             launch on the same rows must give the same payloads, K2 in
             one launch on them the rows K3b gave back (the new K1/K2
             against the per-bit core of K3a/K3b, timed in one call),
             and K3b at the full width must equal the plain decoder on a
             prefix;
12. main_oversize - one 144 MiB block at -b 144, past the 128 MiB
             device-block cap: the host-BWT hybrid (host SA-IS, K3a, K3c,
             host inverse BWT), its launches timed as they run, the host
             SA-IS held against the device BWT, and K3a and K3c at the
             full width against the plain coders on a prefix.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a card, or outside a checkout of the repository, it
exits non-zero before printing any result.  About 12 minutes in all.
"""

from __future__ import annotations

import io
import json
import os
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
# Operations of one CRC lane step (load, xor, mask, table load, shift,
# xor) and of one LZP byte step (hash: 3 shifts/xors and a mask; table
# load and store; tests of the slot and the token; byte load and
# guarded store; context shift and or; loop tests), counted from
# csrc/crc32_kernels.cu and csrc/lzp_kernels.cu.
OPS_PER_CRC_BYTE = 6
OPS_PER_LZP_STEP = 18
# The kernels of each main path; a main phase fails if one of them did
# not launch.
DEFAULT_PATH = ("cm_encode", "cm_decode")
PREPASS_PATH = ("cm_encode", "cm_decode", "crc_lanes", "lzp_encode", "lzp_decode")
B32_PATH = ("cm_encode_resume", "cm_decode_resume")
OVERSIZE_PATH = ("cm_encode_resume", "cm_decode_stream")


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


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card between CUDA events."""
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
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
    from bzip3_tpu_torch.ops.device import cm_cuda, crc32_cuda, lzp_cuda

    return cm_cuda, crc32_cuda, lzp_cuda


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


def phase_build(card: str) -> None:
    from bzip3_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.load_kernels()
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    build.load_host()
    t_host = time.perf_counter() - t0
    # registers, static shared memory and spills of every kernel (-Xptxas -v)
    res = build.kernel_resources()
    for k in ("cm_encode_kernel", "cm_decode_kernel"):
        _require(k in res, f"no -Xptxas -v lines for {k}")
    emit({"phase": "build", "card": card, "kernel_dir": build.KERNEL_DIR,
          "kernels_s": round(t_kernels, 3), "host_s": round(t_host, 3),
          "resources": res})


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
    for name in ("sample_text.bin.bz3", "sample_mixed.bin.bz3"):
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


def _round_trip(card: str, phase: str, data: bytes, bs: int, blocks: int, **switches):
    """``blocks`` x ``bs`` through the stream API on a profiled engine
    with the given pipeline switches: (engine, compressed stream, result
    line with throughput, launches, stage times and peak memory)."""
    import torch
    from bzip3_tpu_torch import compress_file, decompress_file
    from bzip3_tpu_torch.engines import DeviceEngine

    eng = DeviceEngine("cuda", profile=True, **switches)
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


def phase_main(card: str, data: bytes, bs: int, blocks: int) -> dict:
    """The main path at full width: ``blocks`` x ``bs`` through the
    stream API on the card."""
    _, _, out = _round_trip(card, "main", data, bs, blocks)
    launches = out["launches"]
    _require({k for k, v in launches.items() if v} == set(DEFAULT_PATH), launches)
    emit(out)
    return out


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
    points of ``cm_cuda`` while active: two events on the launching
    stream around each launch, so a main path's own K3a-K3c launches are
    timed as they run, with no second run and no synchronise."""

    def __init__(self, *names: str):
        self.events = {n: [] for n in names}

    def __enter__(self):
        import torch
        from bzip3_tpu_torch.ops.device import cm_cuda

        plain = cm_cuda.entry

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
                self.events[name].append((t0, t1))
                return rc

            return timed

        self._restore = (cm_cuda, plain)
        cm_cuda.entry = entry
        return self

    def __exit__(self, *exc) -> None:
        mod, plain = self._restore
        mod.entry = plain

    def ms(self, name: str) -> tuple[float, int]:
        """(summed milliseconds, launches) of entry point ``name``."""
        import torch

        torch.cuda.synchronize()
        ev = self.events[name]
        return sum(t0.elapsed_time(t1) for t0, t1 in ev), len(ev)


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
    0xF2 escapes with and without a live prediction, out_cap."""
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
    ]


def phase_parity_prepass(card: str) -> dict:
    """K4, K5 and K6 against their plain versions on the same rows, byte
    for byte; K4's CRCs against the host C++; step latency of each on
    one row (one thread per row or lane: launch time over steps)."""
    import torch
    from bzip3_tpu_torch.ops import host
    from bzip3_tpu_torch.ops.device import crc32, crc32_cuda, lzp, lzp_cuda

    rows = _lzp_cases()
    n = max(map(len, rows))
    data, lens = _pad(rows, n)
    d_cpu, l_cpu = torch.from_numpy(data), torch.from_numpy(lens)
    d_gpu, l_gpu = d_cpu.cuda(), l_cpu.cuda()
    before = launch_counts()

    # K4: lane states at the device lane count (one byte a lane here)
    # and at 128 lanes (32-byte segments), then whole CRCs.
    k4_err, k4_plain_ms = 0, 0.0
    for lanes in (crc32.LANES, 128):
        t0 = time.perf_counter()
        want = crc32.crc_lane_scan(d_cpu, l_cpu, lanes)
        k4_plain_ms += (time.perf_counter() - t0) * 1e3
        got = crc32_cuda.crc_lane_scan(d_gpu, l_gpu, lanes).cpu()
        _require(got.shape == want.shape, (got.shape, want.shape))
        k4_err = max(k4_err, int((got - want).abs().max()))
    _require(k4_err == 0, "K4 differs from the plain lane scan")
    crcs = crc32_cuda.crc32_batch(d_gpu, l_gpu).cpu().tolist()
    _require(crcs == [host.crc32(r) for r in rows], "K4 CRCs differ from the host C++")
    k4_ms = _cuda_ms(lambda: crc32_cuda.crc_lane_scan(d_gpu, l_gpu, crc32.LANES), 5)

    # K5 against the plain encoder.
    t0 = time.perf_counter()
    p_out, p_lens = lzp.lzp_encode_batch(d_cpu, l_cpu)
    k5_plain_ms = (time.perf_counter() - t0) * 1e3
    k_out, k_lens = lzp_cuda.lzp_encode(d_gpu, l_gpu)
    k_out, k_lens = k_out.cpu().numpy(), k_lens.cpu().numpy()
    p_out, p_lens = p_out.numpy(), p_lens.numpy()
    _require((k_lens == p_lens).all(), (k_lens.tolist(), p_lens.tolist()))
    _require(int((p_lens > 0).sum()) >= 6, f"LZP applied to too few rows: {p_lens.tolist()}")
    k5_err = max(_row_diff(k_out[i, : max(0, p_lens[i])], p_out[i, : max(0, p_lens[i])])
                 for i in range(len(rows)))
    _require(k5_err == 0, "K5 differs from the plain encoder")
    k5_ms = _cuda_ms(lambda: lzp_cuda.lzp_encode(d_gpu, l_gpu), 3)

    # K6 on the encoded rows, a stream cut after its first token, and
    # rows of length 0 and 3; max_out cuts the longest row short.
    enc = [p_out[i, : p_lens[i]].tobytes() for i in range(len(rows)) if p_lens[i] > 0]
    first = next(e for e in enc if 0xF2 in e[4:])
    enc += [first[: first.index(0xF2, 4) + 1], b"", b"abc"]
    e_arr, e_lens = _pad(enc, max(map(len, enc)))
    e_cpu, el_cpu = torch.from_numpy(e_arr), torch.from_numpy(e_lens)
    e_gpu, el_gpu = e_cpu.cuda(), el_cpu.cuda()
    max_out = n - 64
    t0 = time.perf_counter()
    q_out, q_lens = lzp.lzp_decode_batch(e_cpu, el_cpu, max_out)
    k6_plain_ms = (time.perf_counter() - t0) * 1e3
    g_out, g_lens = lzp_cuda.lzp_decode(e_gpu, el_gpu, max_out)
    g_out, g_lens = g_out.cpu().numpy(), g_lens.cpu().numpy()
    q_out, q_lens = q_out.numpy(), q_lens.numpy()
    _require((g_lens == q_lens).all(), (g_lens.tolist(), q_lens.tolist()))
    _require(q_lens[-3:].tolist() == [-1, -1, -1] and (q_lens[:-3] > 0).all(), q_lens.tolist())
    _require(int(q_lens.max()) == max_out, "no row was cut at max_out")
    k6_err = max(_row_diff(g_out[i, : max(0, q_lens[i])], q_out[i, : max(0, q_lens[i])])
                 for i in range(len(enc)))
    _require(k6_err == 0, "K6 differs from the plain decoder")
    k6_ms = _cuda_ms(lambda: lzp_cuda.lzp_decode(e_gpu, el_gpu, max_out), 3)
    parity_launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}

    # Step latency, one thread on one row: K4 on a 64 KiB lane; K5 and
    # K6 on 1 MiB of random bytes without 0xF2, a literal at every step
    # (K5 stops at out_cap after MiB - 8 of them, K6 decodes all MiB).
    rng = np.random.default_rng(13)
    lane = torch.from_numpy(rng.integers(0, 256, (1, 64 << 10), dtype=np.uint8)).cuda()
    lane_len = torch.tensor([64 << 10], dtype=torch.int32).cuda()
    k4_step_ns = _cuda_ms(lambda: crc32_cuda.crc_lane_scan(lane, lane_len, 1), 3) * 1e6 / (64 << 10)
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
        "k4": {"max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms, "shape": [len(rows), n],
               "plain_device": "cpu", "crcs_equal_host": True, "step_ns": k4_step_ns},
        "k5": {"max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms, "shape": [len(rows), n],
               "plain_device": "cpu", "out_lens": p_lens.tolist(), "step_ns": k5_step_ns},
        "k6": {"max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms,
               "shape": list(e_arr.shape), "plain_device": "cpu", "out_lens": q_lens.tolist(),
               "max_out": max_out, "step_ns": k6_step_ns},
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


def phase_main_prepass(card: str, data: bytes, bs: int, blocks: int) -> dict:
    """The device prepass chain at full width: ``blocks`` x ``bs``
    through the stream API on the card, against the default path."""
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
    out.update({"models": models, "identical_to_default_path": True})
    emit(out)
    return out


def phase_prepass_shapes(card: str, data: bytes, bs: int, blocks: int) -> dict:
    """K4, K5 and K6 on the prepass phase's own [blocks, bs] rows, timed
    with CUDA events and checked in full against the host C++: K4's
    CRCs, K5 on the post-RLE rows, K6 back to K5's input."""
    import torch
    from bzip3_tpu_torch.ops import host
    from bzip3_tpu_torch.ops.device import crc32, crc32_cuda, lzp_cuda, rle

    raw = [data[i * bs : (i + 1) * bs] for i in range(blocks)]
    arr, lens = _pad(raw, bs)
    orig, orig_lens = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
    states = crc32_cuda.crc_lane_scan(orig, orig_lens, crc32.LANES)
    crcs = crc32.crc32_from_lanes(states, bs, orig_lens).cpu().tolist()
    _require(crcs == [host.crc32(r) for r in raw], "K4 CRCs differ from the host C++")
    k4_ms = _cuda_ms(lambda: crc32_cuda.crc_lane_scan(orig, orig_lens, crc32.LANES), 5)

    r_out, r_lens = rle.rle_encode_batch(orig, orig_lens, bs + 64)
    use_rle = r_lens < orig_lens
    cur = torch.where(use_rle[:, None], r_out[:, :bs], orig)
    cur_lens = torch.where(use_rle, r_lens, orig_lens)
    del r_out
    (l_out, l_lens), k5_ms = _timed(lambda: lzp_cuda.lzp_encode(cur, cur_lens))
    cur_np, cl = cur.cpu().numpy(), cur_lens.cpu().tolist()
    l_np, ll = l_out.cpu().numpy(), l_lens.cpu().tolist()
    for i in range(blocks):
        want = host.lzp_encode(cur_np[i, : cl[i]].tobytes())
        _require(ll[i] == (-1 if want is None else len(want)), f"K5 length, row {i}")
        _require(want is None or l_np[i, : ll[i]].tobytes() == want, f"K5 bytes, row {i}")
    (d_out, d_lens), k6_ms = _timed(
        lambda: lzp_cuda.lzp_decode(l_out, l_lens.clamp(min=0), bs))
    d_np, dl = d_out.cpu().numpy(), d_lens.cpu().tolist()
    for i in range(blocks):
        if ll[i] >= 0:
            _require(dl[i] == cl[i] and (d_np[i, : dl[i]] == cur_np[i, : cl[i]]).all(),
                     f"K6(K5(x)) differs from x, row {i}")
    # Serial bound of one thread per row: the longest row run alone.
    i5, i6 = int(np.argmax(cl)), int(np.argmax(dl))
    _, k5_row_ms = _timed(lambda: lzp_cuda.lzp_encode(cur[i5 : i5 + 1], cur_lens[i5 : i5 + 1]))
    _, k6_row_ms = _timed(
        lambda: lzp_cuda.lzp_decode(l_out[i6 : i6 + 1], l_lens[i6 : i6 + 1].clamp(min=0), bs))
    k5_steps, k6_steps = cl[i5], max(dl[i6], 1)
    out = {
        "phase": "prepass_shapes", "card": card, "shape": [blocks, bs],
        "row_lens": lens.tolist(), "post_rle_lens": cl, "lzp_lens": ll, "crcs_equal_host": True,
        "k4_ms": k4_ms, "lanes": crc32.LANES, "seg": -(-bs // crc32.LANES),
        "k5_ms": k5_ms, "k6_ms": k6_ms, "k5_equal_host": True, "k6_round_trip": True,
        "k5_ns_per_byte_step": k5_ms * 1e6 / k5_steps, "k6_ns_per_byte_step": k6_ms * 1e6 / k6_steps,
        "k5_steps": k5_steps, "k6_steps": k6_steps,
        "k5_longest_row_alone_ms": k5_row_ms, "k6_longest_row_alone_ms": k6_row_ms,
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


def phase_main_oversize(card: str, data: bytes, prefix: int = 2048) -> dict:
    """One block of len(data) bytes, past the 128 MiB device-block cap,
    through the stream API: the host-BWT hybrid with K3a and K3c, each
    launch timed as it runs.  The host SA-IS is held against the device
    BWT on the block's own post-prepass row; K3a's payload and K3c's
    output at the full width against the plain encoder and decoder on
    the row's first ``prefix`` symbols."""
    import torch
    from bzip3_tpu_torch.ops import host
    from bzip3_tpu_torch.ops.device import cm, cm_cuda
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch
    from bzip3_tpu_torch.pipeline import host_prepass

    bs = len(data)
    _require(os.environ.get("BZ3_TPU_FORCE_OVERSIZE", "0") != "1", "oversize forced")
    with _LaunchTimes("bz3t_cm_encode_resume", "bz3t_cm_decode_resume") as lt:
        eng, comp, out = _round_trip(card, "main_oversize", data, bs, 1)
    _require(eng._pipe(bs).oversize, "the pipeline did not take the oversize path")
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
        "block_mib": bs / MiB, "oversize": True, "model": hdr.model, "post_prepass_len": n,
        "payload_len": len(pay), "launches_wanted": want, "host_sais_s": sais_s,
        "host_inverse_s": out["stages_s"]["decode/bwt"], "device_bwt_s": device_bwt_s,
        "device_bwt_peak_bytes": bwt_peak, "sais_equal_device_bwt": True,
        "prefix": prefix, "k3a_prefix_max_abs_err": err, "k3a_plain_prefix_ms": plain_ms,
        "k3c_prefix_max_abs_err": k3c_err, "k3c_plain_prefix_ms": k3c_plain_ms,
        "k3a_ms": k3a_ms, "k3c_ms": k3c_ms, "timing": "CUDA events around each launch",
    })
    emit(out)
    return out


def _resume_rows(parity: dict, resume: dict, b32: dict, over: dict) -> list[dict]:
    """K3a-K3c: times at [2, 32 Mi] (K3a, K3b; main_b32's own launches)
    and at the oversize row (K3c), launches from those phases.  Beside the
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
    for kid, key, fn, replaces, ph, ins, outs, ns_bit in (
        ("K3a", "cm_encode_resume", "cm_encode_resume_kernel",
         "bzip3_tpu/ops/device/cm_pallas.py:1883", b32, b32["row_lens"], b32["payload_lens"],
         ns["k1_ns_per_bit"]),
        ("K3b", "cm_decode_resume", "cm_decode_resume_kernel",
         "bzip3_tpu/ops/device/cm_pallas.py:1029", b32, b32["payload_lens"], b32["row_lens"],
         ns["k2_ns_per_bit"]),
        ("K3c", "cm_decode_stream", "cm_decode_resume_kernel (out_rel)",
         "bzip3_tpu/ops/device/cm_pallas.py:1100", over, [over["payload_len"]],
         [over["post_prepass_len"]], ns["k2_ns_per_bit"]),
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
            "launches": launches,
            "max_abs_err": max(resume[k]["max_abs_err"], prefix_err[kid]),
            "ms": ph[f"{k}_ms"], "plain_ms": resume[k]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": [len(ins), max(steps)],
            "plain_shape": [resume["rows"], resume["width"]],
            "plain_device": resume[k]["plain_device"],
            "kernel_ms_at_plain_shape": resume[k]["ms"],
            "serial_bound_ms": 8 * max(steps) * ns_bit * 1e-6,
            "spill_bytes": spill, "spill_bound_ms": spill / PEAK_BYTES_PER_S * 1e3,
        })
    rows[0]["launches_oversize"] = over["launches"]["cm_encode_resume"]
    rows[0]["ms_oversize"] = over["k3a_ms"]
    return rows


def kernels_line(parity: dict, main: dict, shapes: dict, pparity: dict, pmain: dict,
                 pshapes: dict, resume: dict, b32: dict, over: dict) -> dict:
    """The kernels of the main paths: launches from the main phases
    (K1/K2 from the default path, K4-K6 from the device prepass chain,
    K3a-K3c from main_b32 and main_oversize), times at their rows, plain
    times from the parity phases (the plain CM coder takes ~0.1 ms a bit
    step: hours at 16 MiB)."""
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
    mid, lz = pshapes["post_rle_lens"], pshapes["lzp_lens"]
    lz_out = [max(0, v) for v in lz]
    dec_out = [mid[i] for i in range(k_rows) if lz[i] >= 0]
    # serial bounds: K4's segment at one lane's measured step latency;
    # K5/K6 the wave's longest row run alone (one thread per row)
    for kid, key, fn, src, src_line, nbytes, ops, serial_ms in (
        # K4: every byte read once, [K, L] int32 lane states written
        ("K4", "crc_lanes", "crc_lane_kernel", "crc32_kernels.cu",
         "bzip3_tpu/ops/device/crc32_pallas.py:45",
         sum(raw) + 4 * k_rows * pshapes["lanes"] + 4 * k_rows,
         OPS_PER_CRC_BYTE * sum(raw), pshapes["seg"] * pparity["k4"]["step_ns"] * 1e-6),
        # K5: post-RLE rows read, LZP streams written; one step a byte
        ("K5", "lzp_encode", "lzp_encode_kernel", "lzp_kernels.cu",
         "bzip3_tpu/ops/device/lzp_pallas.py:135",
         sum(mid) + sum(lz_out) + 8 * k_rows, OPS_PER_LZP_STEP * sum(mid),
         pshapes["k5_longest_row_alone_ms"]),
        # K6: the LZP streams read, the rows they came from written
        ("K6", "lzp_decode", "lzp_decode_kernel", "lzp_kernels.cu",
         "bzip3_tpu/ops/device/lzp_pallas.py:285",
         sum(lz_out) + sum(dec_out) + 8 * k_rows, OPS_PER_LZP_STEP * sum(dec_out),
         pshapes["k6_longest_row_alone_ms"]),
    ):
        k = kid.lower()
        bound_ms, bound_by = _bound(nbytes, ops)
        rows.append({
            "name": f"{kid} {fn}", "route": "cuda",
            "source": f"bzip3_tpu_torch/csrc/{src}", "replaces": src_line,
            "launches": pmain["launches"][key],
            "max_abs_err": pparity[k]["max_abs_err"],
            "ms": pshapes[f"{k}_ms"], "plain_ms": pparity[k]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": pshapes["shape"],
            "plain_shape": pparity[k]["shape"],
            "plain_device": pparity[k]["plain_device"],
            "kernel_ms_at_plain_shape": pparity[k]["ms"],
            "serial_bound_ms": serial_ms,
            "ns_per_step_one_row": pparity[k]["step_ns"],
        })
    rows[2:2] = _resume_rows(parity, resume, b32, over)
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
    phase_build(smi)
    parity = phase_parity(smi)
    pparity = phase_parity_prepass(smi)
    phase_golden(smi)
    bs, blocks = 16 * MiB, 8
    data = corpus(blocks * bs, seed=0)
    main_res = phase_main(smi, data, bs, blocks)
    shapes = phase_main_shapes(smi, data, bs, blocks)
    # 4 text blocks, 3 of log lines, 1 sparse: LZP and RLE both kept
    pdata = data[: 4 * bs] + log_corpus(3 * bs, seed=1) + sparse_block(bs, seed=2)
    pmain = phase_main_prepass(smi, pdata, bs, blocks)
    pshapes = phase_prepass_shapes(smi, pdata, bs, blocks)
    resume = phase_parity_resume(smi)
    log = pdata[4 * bs : 7 * bs]  # 48 MiB of log lines
    b32 = phase_main_b32(smi, data[: 2 * bs] + log[: 2 * bs])
    over = phase_main_oversize(smi, data[: 6 * bs] + log)
    emit(kernels_line(parity, main_res, shapes, pparity, pmain, pshapes, resume, b32, over))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
