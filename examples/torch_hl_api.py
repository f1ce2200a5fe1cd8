#!/usr/bin/env python
"""High-level frame API example for the PyTorch/CUDA port (the port's
counterpart of ``hl_api.py``; cf. the reference's examples/hl-api.c:8-43):
compress a file in memory, decompress it, verify the bytes match.  Runs
on ``cuda`` unless ``--device cpu`` is given.

    python examples/torch_hl_api.py [path] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_harness import split_device  # noqa: E402

import bzip3_tpu_torch  # noqa: E402


def main():
    device, argv = split_device(sys.argv[1:])
    path = argv[0] if argv else "SURVEY.md"
    data = open(path, "rb").read()

    compressed = bzip3_tpu_torch.compress(data, block_size=1024 * 1024, device=device)
    print(f"{path}: {len(data)} -> {len(compressed)} bytes "
          f"({100.0 * len(compressed) / max(1, len(data)):.2f}%) on {device}")

    restored = bzip3_tpu_torch.decompress(compressed, device=device)
    assert restored == data, "round trip failed!"
    print("round trip OK")


if __name__ == "__main__":
    main()
