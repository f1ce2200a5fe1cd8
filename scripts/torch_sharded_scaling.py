#!/usr/bin/env python3
"""The sharded engine over the cards of one machine, against one card,
and the multi-host layer with one NCCL rank a card.

    python3 scripts/torch_sharded_scaling.py [--blocks N]

Run it on a machine with several cards.  Main's 8 blocks of 16 MiB
(``chip_smoke.corpus(128 MiB, seed=0)``, as chip_smoke's main phase makes
them), repeated to ``N`` blocks (default 32), go through ``compress_file``
/ ``decompress_file`` at -b 16 on the sharded engine over the first card
alone and then over every card; the two streams must be equal.  Each run
prints its MiB/s, stage seconds, each share's K1 and K2 milliseconds
(CUDA events on its stream) and each card's peak memory.  Then one
process a card joins a job over NCCL (``multihost.initialize``'s default
on a card; each rank sees its own card through CUDA_VISIBLE_DEVICES),
codes its ``host_stripe`` of main's 8 blocks and gathers them to rank 0
(``gather_to_writer``), which holds them against the first 8 blocks of
the one-card stream.  Every line names the cards and their power limits.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from bzip3_tpu_torch.engines import DeviceEngine
    from bzip3_tpu_torch.ops import build

    torch.cuda.init()  # the allocator of every card, for its peak counters
    cards = torch.cuda.device_count()
    if cards < 2:
        raise RuntimeError(f"needs several cards, sees {cards}")
    card = "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines())
    build.load_kernels()
    build.load_host()
    bs, blocks = 16 * MiB, args.blocks
    base = cs.corpus(8 * bs, seed=0)
    data = (base * -(-blocks // 8))[: blocks * bs]
    streams = {}
    for run, mesh in (("one_card", ["cuda:0"]), ("every_card", None)):
        eng = DeviceEngine("cuda", profile=True, sharded=True, mesh=mesh)
        for i in range(cards):
            torch.cuda.reset_peak_memory_stats(i)
        _, streams[run], out = cs._round_trip(card, "sharded_scaling", data, bs, blocks,
                                              engine=eng)
        ms = eng.share_ms()
        out.update(run=run, mesh=[str(d) for d in eng.mesh],
                   share_k1_ms=[m["encode/cm"] for m in ms],
                   share_k2_ms=[m["decode/cm"] for m in ms],
                   peak_device_bytes=[torch.cuda.max_memory_allocated(i) for i in range(cards)])
        print(json.dumps(out), flush=True)
    if streams["one_card"] != streams["every_card"]:
        raise RuntimeError("the sharded stream over every card differs from one card's")

    n = 8
    coded = [b for _, b in cs._chunks(streams["one_card"], bs)[:n]]
    os.makedirs(cs.MULTIHOST_DIR, exist_ok=True)
    job = os.path.join(cs.MULTIHOST_DIR, "scaling_job.pickle")
    with open(job, "wb") as f:
        pickle.dump({"data": base, "blocks": coded}, f)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prefix = os.path.join(cs.MULTIHOST_DIR, "scaling_nccl")
    ranks = cs._results(cs._spawn(job, prefix, bs, n, "default", True, cards, card_each=True),
                        prefix, "nccl")
    wall = time.perf_counter() - t0
    if not (ranks[0]["equal"] and all(r["backend"] == "nccl" for r in ranks)):
        raise RuntimeError(f"NCCL ranks: {ranks}")
    print(json.dumps({"phase": "sharded_scaling", "run": "nccl_rank_a_card", "card": card,
                      "block_size": bs, "blocks": n, "ranks": ranks, "wall_s": wall}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
