#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``bzip3_tpu_torch``): one run
of one cell of ``BENCHMARK.json`` on the card, from the root of a
checkout.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``portbench/harness/main.py`` for what it prints."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of kernel compilers at fixed places inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = os.path.join(ROOT, "_build", "portbench", sub)
sys.path.insert(0, ROOT)

if __name__ == "__main__":  # the reference's worker processes import this file too
    from portbench.harness.main import main

    sys.exit(main(sys.argv[1:], T0))
