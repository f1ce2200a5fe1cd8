#!/usr/bin/env python3
"""Row groups of the forward and inverse BWT, and the host pool, on one card.

    python3 scripts/torch_wave_groups.py [--blocks 32] [--bs-mib 16] [--out FILE]

Run from the root of a checkout on a machine with a CUDA card.  On one
wave of ``--blocks`` blocks of ``--bs-mib`` MiB (chip_smoke.py's text,
log lines and a sparse block, repeated), after the host pre-pass:

- pre-pass: every block's CRC and RLE/LZP pre-pass on one thread and on
  the pipeline's pool of ``os.cpu_count()`` threads;
- forward: the forward BWT of the wave in groups of 4, 8, 16 and 32 rows
  (each group at the wave's width): seconds and peak device memory; then
  groups of 16 again while the pool runs the pre-pass of every block, to
  show what the pool's threads cost the BWT's Python;
- inverse: the inverse BWT in groups of 1, 2, 4, 8 and 16 rows: the
  inverse alone (seconds, peak memory), then as the decode runs it, each
  group's rows down and the host post-pass (un-LZP, un-RLE, CRC) of each
  group on the pool while the next group runs, to the last future.

Prints one JSON line a measurement, the card's name and power limit, and
writes them all to ``--out`` (default ``_build/wave_groups.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _sync_s(fn):
    """(fn(), host seconds to its end on the card)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--bs-mib", type=float, default=16)
    ap.add_argument("--out", default=os.path.join(ROOT, "_build", "wave_groups.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_wave_groups: a CUDA card is needed", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bzip3_tpu_torch.container.bound import bound
    from bzip3_tpu_torch.ops import host
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch, bwt_inverse_batch
    from bzip3_tpu_torch.pipeline import host_prepass

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    bs = int(args.bs_mib * (1 << 20))
    text = cs.corpus(8 * bs, seed=0)
    base = text + cs.log_corpus(3 * bs, seed=1) + cs.sparse_block(bs, seed=2)
    blocks = [base[(i % 12) * bs : (i % 12 + 1) * bs] for i in range(args.blocks)]
    lines = []

    def emit(obj):
        obj["card"] = smi
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    def prepass(data):
        return host.crc32(data), host_prepass(data)

    t0 = time.perf_counter()
    pre = [prepass(b) for b in blocks]
    one_s = time.perf_counter() - t0
    threads = os.cpu_count() or 4
    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        list(pool.map(prepass, blocks))
        pool_s = time.perf_counter() - t0
    emit({"what": "prepass", "blocks": len(blocks), "one_thread_s": one_s,
          "pool_threads": threads, "pool_s": pool_s, "speedup": one_s / pool_s})

    rows = [p[1][3] for p in pre]
    arr, lens = cs._pad(rows, -(-max(map(len, rows)) // 256) * 256)
    cur, l_gpu = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
    k, n = cur.shape

    def forward(g):
        parts = [bwt_forward_batch(cur[s : s + g], l_gpu[s : s + g]) for s in range(0, k, g)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    u1, i1 = bwt_forward_batch(cur[:1], l_gpu[:1])  # warm up
    bwt_inverse_batch(u1, l_gpu[:1], i1)
    u = idx = None
    for g in (4, 8, 16, 32):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            (u_g, idx_g), sec = _sync_s(lambda: forward(g))
        except torch.cuda.OutOfMemoryError as e:
            emit({"what": "forward", "group_rows": g, "error": str(e)[:200]})
            continue
        if u is None:
            u, idx = u_g, idx_g
        else:
            cs._require(torch.equal(u, u_g) and torch.equal(idx, idx_g), f"groups of {g} differ")
        del u_g, idx_g
        emit({"what": "forward", "group_rows": g, "shape": [k, n], "s": sec,
              "ms_a_row": sec * 1e3 / k, "peak_bytes": torch.cuda.max_memory_allocated(),
              "peak_bytes_a_byte": torch.cuda.max_memory_allocated() / (min(g, k) * n)})
    with ThreadPoolExecutor(threads) as pool:
        futs = [pool.submit(prepass, b) for b in blocks]
        _, sec = _sync_s(lambda: forward(16))
        busy = sum(not f.done() for f in futs)
        [f.result() for f in futs]
    emit({"what": "forward_beside_pool", "group_rows": 16, "s": sec,
          "prepasses_still_running_at_end": busy})

    sizes = lens.tolist()
    bnd = bound(bs)

    def post(row, meta, crc):
        model, _, _, _ = meta
        out = row
        if model & 2:
            out = host.lzp_decode(out, bnd)
        if model & 4:
            out = host.rle_decode(out, bs)
        return host.crc32(out) == crc

    for g in (1, 2, 4, 8, 16):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, alone = _sync_s(lambda: [bwt_inverse_batch(u[s : s + g], l_gpu[s : s + g],
                                                      idx[s : s + g]) for s in range(0, k, g)])
        peak = torch.cuda.max_memory_allocated()
        with ThreadPoolExecutor(threads) as pool:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            futs = []
            for s in range(0, k, g):
                arr_g = bwt_inverse_batch(u[s : s + g], l_gpu[s : s + g], idx[s : s + g])
                arr_g = arr_g.cpu().numpy()
                for j in range(arr_g.shape[0]):
                    futs.append(pool.submit(post, arr_g[j, : sizes[s + j]].tobytes(),
                                            pre[s + j][1], pre[s + j][0]))
            last_group = time.perf_counter() - t0
            ok = all(f.result() for f in futs)
            total = time.perf_counter() - t0
        cs._require(ok, f"inverse groups of {g}: a row's CRC differs")
        emit({"what": "inverse", "group_rows": g, "alone_s": alone, "peak_bytes": peak,
              "peak_bytes_a_byte": peak / (min(g, k) * n),
              "with_d2h_and_pool_s": total, "to_last_group_s": last_group,
              "post_exposed_s": total - last_group})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
