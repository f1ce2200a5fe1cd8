#!/usr/bin/env python3
"""Where a benchmark run's set-up goes, in the harness's order: the
imports, the CUDA context, the file made on the card, the native
libraries' builds and loads (``ops.build.LOADS``), and the warm-up round
trip of the file's first MiB (the libraries load inside it).

    python3 scripts/torch_setup_split.py [--workload b16-wave.enwik9-rt] [--seed N]

Run from the root of a checkout on a card; prints one JSON line of
seconds.  ``python -X importtime`` of the same imports says which module
the import time is spent in."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

T_TORCH = time.perf_counter()

from bzip3_tpu_torch.ops import build  # noqa: E402
from portbench import corpora  # noqa: E402
from portbench.harness import main as hm, spans as sp, spec, window  # noqa: E402


def main() -> int:
    t_imports = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="b16-wave.enwik9-rt")
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(), args.workload)
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_context = time.perf_counter() - t
    t = time.perf_counter()
    data = corpora.generate(cell["traffic"], args.seed, "cuda", 1.0)
    t_file = time.perf_counter() - t
    engine = hm.make_engine(cell["config"], "cuda", False)
    spans = sp.Spans()
    t = time.perf_counter()
    warm = window.round_trip(data[: hm.WARMUP_BYTES], cell["config"]["block_size"],
                             sp.SpanEngine(engine, spans), spans, torch.cuda.synchronize)
    t_warm = time.perf_counter() - t
    if warm["error"] is not None or warm["decoded"] != data[: hm.WARMUP_BYTES]:
        print(f"warm-up round trip failed: {warm['error']}", file=sys.stderr)
        return 1
    print(json.dumps({
        "workload": args.workload, "card": torch.cuda.get_device_name(0),
        "power_limit_w": hm.power_limit_w(), "torch": torch.__version__,
        "import_torch_s": T_TORCH - T0, "import_rest_s": t_imports - T_TORCH,
        "cuda_context_s": t_context, "file_s": t_file, "warm_up_s": t_warm,
        "libraries_s": build.LOADS, "total_s": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
