#!/usr/bin/env python3
"""K5 and K6 (the port's LZP kernels) of one checkout, timed on the card
at the device prepass chain's own rows.

    python3 scripts/torch_lzp_ab.py [--checkout DIR] [--reps N]

The rows are those of ``chip_smoke.py``'s main_prepass phase: 8 blocks
of 16 MiB (4 of text, 3 of access-log lines, 1 sparse), after the
device RLE where it shrinks them.  ``DIR`` (default: this checkout) is
the checkout whose ``bzip3_tpu_torch`` is imported and whose kernels are
built (into its own ``_build/``), so that two versions are compared in
one call on one card: parent, change, change, parent.  The data are
made by this checkout's ``chip_smoke.py`` and cached in
``_build/lzp_ab_data.bin``.  After one untimed call each, K5 and K6 run
``N`` times (CUDA events around each launch), each output checked in
full against the host C++ (K5) and the rows (K6).  Where the checkout's
wrappers take ``stats``, each row's counters are printed too.  Prints
one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20


def _data(bs: int) -> bytes:
    path = os.path.join(ROOT, "_build", "lzp_ab_data.bin")
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
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_lzp_ab: a CUDA card is needed", file=sys.stderr)
        return 2
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    from bzip3_tpu_torch.ops import build, host
    from bzip3_tpu_torch.ops.device import lzp_cuda, rle

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
    orig = torch.from_numpy(arr.copy()).cuda()
    orig_lens = torch.full((blocks,), bs, dtype=torch.int32, device="cuda")
    r_out, r_lens = rle.rle_encode_batch(orig, orig_lens, bs + 64)
    use_rle = r_lens < orig_lens
    cur = torch.where(use_rle[:, None], r_out[:, :bs], orig).contiguous()
    cur_lens = torch.where(use_rle, r_lens, orig_lens)
    del r_out, orig

    counted = "stats" in inspect.signature(lzp_cuda.lzp_encode).parameters
    s5 = torch.zeros((blocks, lzp_cuda.STATS), dtype=torch.int32, device="cuda") if counted else None
    s6 = torch.zeros_like(s5) if counted else None
    kw5 = {"stats": s5} if counted else {}
    kw6 = {"stats": s6} if counted else {}

    def timed(fn):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        res = fn()
        t1.record()
        torch.cuda.synchronize()
        return res, t0.elapsed_time(t1)

    enc = lambda: lzp_cuda.lzp_encode(cur, cur_lens, **kw5)  # noqa: E731
    (l_out, l_lens), _ = timed(enc)
    k5_ms = [timed(enc)[1] for _ in range(args.reps)]
    cl, ll = cur_lens.cpu().tolist(), l_lens.cpu().tolist()
    cur_np, l_np = cur.cpu().numpy(), l_out.cpu().numpy()
    for i in range(blocks):
        want = host.lzp_encode(cur_np[i, : cl[i]].tobytes())
        if ll[i] != (-1 if want is None else len(want)) or (
                want is not None and l_np[i, : ll[i]].tobytes() != want):
            raise RuntimeError(f"K5 differs from the host C++ on row {i}")
    in_lens = l_lens.clamp(min=0)
    dec = lambda: lzp_cuda.lzp_decode(l_out, in_lens, bs, **kw6)  # noqa: E731
    (d_out, d_lens), _ = timed(dec)
    k6_ms = [timed(dec)[1] for _ in range(args.reps)]
    dl, d_np = d_lens.cpu().tolist(), d_out.cpu().numpy()
    for i in range(blocks):
        if ll[i] >= 0 and (dl[i] != cl[i] or not (d_np[i, : dl[i]] == cur_np[i, : cl[i]]).all()):
            raise RuntimeError(f"K6(K5(x)) differs from x on row {i}")
    out = {
        "script": "torch_lzp_ab", "card": smi, "checkout": checkout, "shape": [blocks, bs],
        "post_rle_lens": cl, "lzp_lens": ll, "build_s": build_s, "reps": args.reps,
        "k5_ms": k5_ms, "k6_ms": k6_ms, "k5_equal_host": True, "k6_round_trip": True,
    }
    if counted:
        out["k5_stats"] = s5.cpu().tolist()
        out["k6_stats"] = s6.cpu().tolist()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
