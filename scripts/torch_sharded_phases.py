#!/usr/bin/env python3
"""chip_smoke.py's multi-device phases alone, for a quick check on one
card.

    python3 scripts/torch_sharded_phases.py

Builds the kernels (``phase_build``), then runs ``phase_dryrun``,
``phase_main`` (8 blocks of 16 MiB of ``corpus(128 MiB, seed=0)`` at -b
16, whose stream the next phases must reproduce), ``phase_main_sharded``
and ``phase_multihost``, each printing its JSON line, and last the
card's name and power limit with the seconds taken: about two minutes
against the whole smoke's ten.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cs.phase_build(card)
    cs.phase_dryrun(card)
    bs, blocks = 16 * cs.MiB, 8
    data = cs.corpus(blocks * bs, seed=0)
    _, stream = cs.phase_main(card, data, bs, blocks)
    cs.phase_main_sharded(card, data, bs, blocks, stream)
    cs.phase_multihost(card, data, bs, stream)
    print(card, "total_s", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
