#!/usr/bin/env python3
"""The control and the faults of ``correct``, on the card at a cell's own
size: one op each, for each seed, with the checks that decide
``correct`` and whether it came out false (as it must).

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--what split unchanged ...]

``split`` is the control (``harness/faults.py``), ``sound`` the program
itself (the lower readings); the others are faults.  One JSON line a
(what, seed); the last line says whether every sound run came out
correct and every other not.  The benchmark's own runs never run this."""

import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv: list[str]) -> int:
    import argparse

    from portbench.harness import faults
    from portbench.harness.main import log, run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["split"],
                    choices=["sound", "split", *faults.FAULTS])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: no result")
        return 2
    as_due = True
    for what in args.what:
        for seed in args.seeds:
            kw = ({} if what == "sound" else
                  {"round_trip": faults.split_round_trip} if what == "split"
                  else {"wrap": faults.FAULTS[what]})
            t = time.perf_counter()
            r = run_cell(args.workload, seed, 0.0, False, device="cuda",
                         min_ops=2 if what == "flaky" else 1, **kw)
            as_due &= r["correct"] == (what == "sound")
            print(json.dumps({"what": what, "seed": seed, "correct": r["correct"],
                              "attempted": r["attempted"], "failed": r["failed"],
                              "seconds": time.perf_counter() - t,
                              "checks": {k: c["value"] for k, c in r["checks"].items()}}),
                  flush=True)
    print(json.dumps({"as_due": as_due}), flush=True)
    return 0 if as_due else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
