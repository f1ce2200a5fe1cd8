#!/usr/bin/env python3
"""The default path's ``main`` phase of one checkout, run several times
on the card, so that two versions can be compared in one call.

    python3 scripts/torch_main_ab.py [--checkout DIR] [--reps N]

``DIR`` (default: this checkout) is the checkout whose ``chip_smoke.py``
and ``bzip3_tpu_torch`` are imported and whose kernels and host passes
are built (into its own ``_build/``).  After the build, its
``phase_main`` runs ``N`` times (default 2) on the same data: 8 blocks of
16 MiB of ``corpus(128 MiB, seed=0)``, made by this checkout's
``chip_smoke.py`` as its main phase makes them, through
``compress_file`` / ``decompress_file`` at -b 16 with BZ3_TPU_CM unset.
It prints one JSON line with each run's MiB/s and stage seconds and the
card's name and power limit.  Run it as parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=ROOT)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    checkout = os.path.abspath(args.checkout)
    os.environ.pop("BZ3_TPU_CM", None)
    bs, blocks = 16 * MiB, 8
    data = _module(os.path.join(ROOT, "chip_smoke.py"), "smoke_data").corpus(blocks * bs, seed=0)
    sys.path.insert(0, checkout)
    smoke = _module(os.path.join(checkout, "chip_smoke.py"), "smoke_under_test")
    from bzip3_tpu_torch.ops import build

    if not os.path.dirname(build.__file__).startswith(checkout):
        raise RuntimeError(f"bzip3_tpu_torch came from {build.__file__}, not {checkout}")
    build.load_kernels()
    build.load_host()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    runs = []
    for _ in range(args.reps):
        with contextlib.redirect_stdout(io.StringIO()):  # the phase's own line
            res, _ = smoke.phase_main(card, data, bs, blocks)
        runs.append({k: res[k] for k in ("encode_mib_s", "decode_mib_s", "encode_s", "decode_s",
                                         "stages_s")})
    print(json.dumps({"script": "torch_main_ab", "card": card, "checkout": checkout,
                      "shape": [blocks, bs], "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
