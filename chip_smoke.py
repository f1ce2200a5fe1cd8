#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bzip3_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper
card (the kernels are built for sm_90a).  Phases, each printing one
JSON line:

1. device  - the card's name and power limit (``nvidia-smi``);
2. build   - the CUDA kernels from ``bzip3_tpu_torch/csrc/*.cu`` into
             ``_build/torch_kernels/`` (nvcc), the host passes with g++;
3. parity  - K1 (CM encode) and K2 (CM decode) on the card against
             their plain PyTorch versions on CPU copies of the same
             rows, byte for byte; K2(K1(x)) == x on two 1 MiB rows;
4. golden  - the reference-made ``tests/data/*.bz3`` decode on the
             card, and re-encode to the same bytes;
5. main    - 8 blocks x 16 MiB of seeded text through ``compress_file``
             / ``decompress_file`` at -b 16 on the card, with launch
             counts, stage times, throughput and peak device memory;
6. main_shapes - K1 and K2 on that path's own rows (post-prepass,
             post-BWT, [8, ~16 Mi]): timed, K2(K1(u)) == u, and each
             against its plain version on every row's first 2 KiB.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a card, or outside a checkout of the repository, it
exits non-zero before printing any result.
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
    ptxas = [ln.strip() for ln in build.kernel_build_log().splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    emit({"phase": "build", "card": card, "kernel_dir": build.KERNEL_DIR,
          "kernels_s": round(t_kernels, 3), "host_s": round(t_host, 3),
          "ptxas": ptxas})


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
        rng.integers(0, 256, n, dtype=np.uint8).tobytes(),  # payload over the cap below
    ]
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
    enc_err = max(_row_diff(k_out[i, : p_lens[i]], p_out[i, : p_lens[i]]) for i in range(8))
    _require(enc_err == 0, "K1 differs from the plain encoder")

    # K1 with an output cap that the last row's payload exceeds: the
    # true length is reported and the bytes under the cap are exact.
    cap = 3072
    c_out, c_lens = cm_cuda.cm_encode(d_gpu, l_gpu, cap)
    c_out, c_lens = c_out.cpu().numpy(), c_lens.cpu().numpy()
    _require((c_lens == p_lens).all() and (c_lens > cap).tolist() == [False] * 7 + [True],
             f"capped K1 lengths {c_lens.tolist()}")
    for i in range(8):
        m = min(int(p_lens[i]), cap)
        _require(_row_diff(c_out[i, :m], p_out[i, :m]) == 0, f"capped row {i}")

    # K2 on the plain payloads, one cut in half (stream exhaustion).
    pays = [p_out[i, : p_lens[i]].tobytes() for i in range(8)]
    pays[1] = pays[1][: len(pays[1]) // 2]
    pdata, plens = _pad(pays, int(p_lens.max()))
    pd_cpu, pl_cpu = torch.from_numpy(pdata), torch.from_numpy(plens)
    t0 = time.perf_counter()
    p_dec = cm.cm_decode_batch(pd_cpu, pl_cpu, l_cpu, n).numpy()
    dec_plain_ms = (time.perf_counter() - t0) * 1e3
    pd_gpu, pl_gpu = pd_cpu.cuda(), pl_cpu.cuda()
    k_dec = cm_cuda.cm_decode(pd_gpu, pl_gpu, l_gpu, n).cpu().numpy()
    dec_err = max(_row_diff(k_dec[i, : lens[i]], p_dec[i, : lens[i]]) for i in range(8))
    _require(dec_err == 0, "K2 differs from the plain decoder")
    for i in range(8):
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
        "phase": "parity", "card": card, "rows": 8, "width": n, "tolerance": 0,
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


def phase_main(card: str, data: bytes, bs: int, blocks: int) -> dict:
    """The main path at full width: ``blocks`` x ``bs`` through the
    stream API on the card."""
    import torch
    from bzip3_tpu_torch import compress_file, decompress_file
    from bzip3_tpu_torch.engines import DeviceEngine
    from bzip3_tpu_torch.ops.device import cm_cuda

    eng = DeviceEngine("cuda", profile=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cm_cuda.reset_launches()
    t0 = time.perf_counter()
    comp = io.BytesIO()
    compress_file(io.BytesIO(data), comp, bs, engine=eng, batch_size=blocks)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = io.BytesIO()
    decompress_file(io.BytesIO(comp.getvalue()), back, engine=eng, batch_size=blocks)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = dict(cm_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    _require(back.getvalue() == data, "main path round trip differs")
    _require(launches["cm_encode"] > 0 and launches["cm_decode"] > 0, launches)
    _require(eng.reencoded_rows == 0, eng.reencoded_rows)
    out = {
        "phase": "main", "card": card, "block_size": bs, "blocks": blocks,
        "input_bytes": len(data), "compressed_bytes": len(comp.getvalue()),
        "ratio": len(comp.getvalue()) / len(data),
        "encode_s": enc_s, "decode_s": dec_s,
        "encode_mib_s": len(data) / MiB / enc_s,
        "decode_mib_s": len(data) / MiB / dec_s,
        "launches": launches, "reencoded_rows": eng.reencoded_rows,
        "peak_device_bytes": peak,
        "stages_s": {k: round(v, 6) for k, v in eng.timer.totals.items()},
        "stage_calls": dict(eng.timer.counts),
    }
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
        "k1_prefix_max_abs_err": enc_err, "k2_prefix_max_abs_err": dec_err,
        "k1_plain_prefix_ms": enc_plain_ms, "k2_plain_prefix_ms": dec_plain_ms,
        "plain_device": "cpu",
    }
    emit(out)
    return out


def kernels_line(parity: dict, main: dict, shapes: dict) -> dict:
    """The kernels of the main path: launches from the main phase,
    times from the main-shape phase, plain times from the parity phase
    (the plain coder takes ~0.2 ms a bit step: hours at 16 MiB)."""
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
    phase_golden(smi)
    bs, blocks = 16 * MiB, 8
    data = corpus(blocks * bs, seed=0)
    main_res = phase_main(smi, data, bs, blocks)
    shapes = phase_main_shapes(smi, data, bs, blocks)
    emit(kernels_line(parity, main_res, shapes))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
