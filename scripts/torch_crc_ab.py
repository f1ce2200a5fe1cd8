#!/usr/bin/env python3
"""K4 (the port's CRC-32C lane scan) of one checkout, timed on the card
at the device prepass chain's own rows.

    python3 scripts/torch_crc_ab.py [--checkout DIR] [--reps N] [--round-trip]

The rows are those of ``chip_smoke.py``'s main_prepass phase: 8 blocks
of 16 MiB (4 of text, 3 of access-log lines, 1 sparse), the rows that
its ``encode/crc`` stage and, after the round trip, its
``decode/crc_verify`` stage checksum.  ``DIR`` (default: this checkout)
is the checkout whose ``bzip3_tpu_torch`` is imported and whose kernels
are built (into its own ``_build/``), so that two versions are compared
in one call on one card: parent, change, change, parent.  The data are
made by this checkout's ``chip_smoke.py`` and cached in
``_build/prepass_ab_data.bin``.

K4 runs at the lane count the checkout's ``crc32_cuda.crc32_batch``
gives it.  After one untimed call, three times ``N`` calls are queued
behind a sleeping kernel and timed between two CUDA events (``k4_ms``,
the device time a call: the kernel and the wrapper's int64 conversion,
without host gaps); then ``N`` calls each after a read of 256 MiB that
leaves none of the rows in L2 (``k4_cold_ms``, CUDA events around the
call, queued behind a short sleep); then ``crc32_batch`` (K4, the lane combine and the pad unwind)
``N`` times on the host clock to a synchronise, as a stage of the
pipeline is timed.  Every CRC is checked against the host C++.  With
``--round-trip``, the rows then go through the checkout's device prepass
chain (``compress_file`` / ``decompress_file``, ``device_prepass=True``,
as main_prepass runs them) and its ``encode/crc`` and
``decode/crc_verify`` stage times are printed beside the chain's MiB/s.
Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20


def _data(bs: int) -> bytes:
    path = os.path.join(ROOT, "_build", "prepass_ab_data.bin")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    spec = importlib.util.spec_from_file_location("smoke_data", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = smoke.corpus(8 * bs, seed=0)[: 4 * bs] + smoke.log_corpus(3 * bs, seed=1) \
        + smoke.sparse_block(bs, seed=2)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)
    return data


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=ROOT)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--round-trip", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_crc_ab: a CUDA card is needed", file=sys.stderr)
        return 2
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    from bzip3_tpu_torch.ops import build, host
    from bzip3_tpu_torch.ops.device import crc32, crc32_cuda

    if not build.__file__.startswith(checkout):
        raise RuntimeError(f"imported {build.__file__}, not from {checkout}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    bs, blocks = 16 * MiB, 8
    data = _data(bs)
    t0 = time.perf_counter()
    build.load_kernels()
    build.load_host()
    build_s = time.perf_counter() - t0

    arr = np.frombuffer(data, np.uint8).reshape(blocks, bs)
    rows = torch.from_numpy(arr.copy()).cuda()
    lens = torch.full((blocks,), bs, dtype=torch.int32, device="cuda")
    want = [host.crc32(arr[i].tobytes()) for i in range(blocks)]
    # the lane count the checkout's crc32_batch gives K4
    lanes = crc32_cuda.lanes_for(rows) if hasattr(crc32_cuda, "lanes_for") else crc32.LANES
    flush = torch.ones(64 * MiB, dtype=torch.int32, device="cuda")

    def queued(fn, reps: int) -> float:
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # ~25 ms: the calls queue behind it
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def cold(fn) -> float:
        torch.cuda.synchronize()
        flush.sum()  # reads 256 MiB; leaves no dirty lines behind
        torch.cuda._sleep(2_000_000)  # ~1 ms: the call queues behind it
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)

    scan = lambda: crc32_cuda.crc_lane_scan(rows, lens, lanes)  # noqa: E731
    states = scan()
    got = crc32.crc32_from_lanes(states, bs, lens).cpu().tolist()
    if got != want:
        raise RuntimeError(f"K4 CRCs differ from the host C++: {got} != {want}")
    k4_ms = [queued(scan, args.reps) for _ in range(3)]
    k4_cold_ms = [cold(scan) for _ in range(args.reps)]
    batch_ms = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crcs = crc32_cuda.crc32_batch(rows, lens)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    if crcs.cpu().tolist() != want:
        raise RuntimeError("crc32_batch differs from the host C++")
    res = build.kernel_resources().get("crc_lane_kernel", {})
    out = {
        "script": "torch_crc_ab", "card": smi, "checkout": checkout, "shape": [blocks, bs],
        "lanes": int(states.shape[1]), "seg": -(-bs // int(states.shape[1])),
        "build_s": build_s, "reps": args.reps, "registers": res.get("registers"),
        "k4_ms": k4_ms, "k4_cold_ms": k4_cold_ms, "crc32_batch_ms": batch_ms,
        "k4_ms_mean": float(np.mean(k4_ms)), "k4_cold_ms_median": float(np.median(k4_cold_ms)),
        "crc32_batch_ms_median": float(np.median(batch_ms)), "crcs_equal_host": True,
    }
    if args.round_trip:
        out["round_trip"] = _round_trip(data, bs, blocks)
    print(json.dumps(out), flush=True)
    return 0


def _round_trip(data: bytes, bs: int, blocks: int) -> dict:
    """The chain's round trip of ``data`` on a profiled engine: MiB/s and
    the CRC stages' seconds (each stage closed by a synchronise)."""
    import torch
    from bzip3_tpu_torch import compress_file, decompress_file
    from bzip3_tpu_torch.engines import DeviceEngine

    eng = DeviceEngine("cuda", device_prepass=True, profile=True)
    torch.cuda.synchronize()
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
    if back.getvalue() != data:
        raise RuntimeError("the chain's round trip differs")
    st = eng.timer.totals
    return {"encode_mib_s": len(data) / MiB / enc_s, "decode_mib_s": len(data) / MiB / dec_s,
            "compressed_bytes": len(comp.getvalue()),
            "stages_s": {k: st[k] for k in ("encode/crc", "decode/crc_verify")}}


if __name__ == "__main__":
    sys.exit(main())
