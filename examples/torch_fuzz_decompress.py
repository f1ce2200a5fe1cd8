#!/usr/bin/env python
"""Frame-level decompress fuzzer for the PyTorch/CUDA port (the port's
counterpart of ``fuzz_decompress.py``; cf. the reference's
examples/fuzz-decompress.c).

Random and mutated BZ3v1 frames go through
``bzip3_tpu_torch.decompress(blob, max_output=1 << 24)`` on the device
engine; each must decode correctly or raise a clean Bz3Error, and its
outcome must equal the native engine's: the same bytes or, where it
raises, the same code as the pipeline over the host coder
(``torch_harness.ReferenceEngine``), and an error from the native engine
too.  A ``torch.cuda.synchronize()`` follows every frame.

    python examples/torch_fuzz_decompress.py [seed|path] [iterations] [--device cpu] [--engine native]

``--engine native`` fuzzes the host C++ engine in place of the device
engine (the CPU lane at volume).
"""

from __future__ import annotations

import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_harness import (  # noqa: E402
    ReferenceEngine,
    outcome,
    require,
    run_main,
    same_verdict,
    split_device,
    sync,
    trial,
)

import bzip3_tpu_torch  # noqa: E402
from bzip3_tpu_torch.engines import DeviceEngine, NativeEngine  # noqa: E402

MAX_OUTPUT = 1 << 24


def jax_inputs(seed: int, iters: int) -> tuple[bytes, list[bytes]]:
    """The JAX harness's frames for ``seed``, draw for draw: (the valid
    frame of 3,000 random bytes at a block size of 65 KiB, [garbage after
    the magic, bit-flipped and truncated copies of it] x iters)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    valid = bzip3_tpu_torch.compress(data, 65 * 1024, engine=NativeEngine(0))
    out = []
    for it in range(iters):
        mode = it % 3
        if mode == 0:
            n = int(rng.integers(0, 100))
            blob = b"BZ3v1" + rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif mode == 1:
            b = bytearray(valid)
            for _ in range(int(rng.integers(1, 6))):
                b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            blob = bytes(b)
        else:
            blob = valid[: int(rng.integers(0, len(valid)))]
        out.append(blob)
    return valid, out


class Engines:
    """The engine under test (the device engine on ``device``, or with
    ``engine="native"`` the host C++ one) and its two references."""

    def __init__(self, device, engine: str = "device"):
        self.device = device
        self.nat = NativeEngine(0)
        self.dev = self.nat if engine == "native" else DeviceEngine(
            device, device_prepass=False, host_crc=True, device_crc_verify=False)
        self.ref = ReferenceEngine()


def check_frame(seed, index, blob: bytes, eng: Engines, stats: Counter) -> tuple:
    dec = bzip3_tpu_torch.decompress
    got = outcome(dec, blob, engine=eng.dev, max_output=MAX_OUTPUT)
    sync(eng.device)
    want = outcome(dec, blob, engine=eng.ref, max_output=MAX_OUTPUT)
    nat = outcome(dec, blob, engine=eng.nat, max_output=MAX_OUTPUT)
    exact = eng.dev is not eng.nat  # the native engine's codes are its own
    require(got == want if exact else same_verdict(got, want), seed, index,
            f"frame: {got[0]} {got[1] if got[0] == 'err' else ''} "
            f"against the pipeline over the host coder's {want[0]} "
            f"{want[1] if want[0] == 'err' else ''}")
    require(same_verdict(got, nat), seed, index,
            f"frame: {got[0]} against the native engine's {nat[0]}")
    stats[got[1] if got[0] == "err" else "ok"] += 1
    return got


def run(seed: int = 0, iters: int = 200, device="cuda", engine: str = "device",
        log=print) -> dict:
    eng = Engines(device, engine)
    stats: Counter = Counter()
    for i, blob in enumerate(jax_inputs(seed, iters)[1]):
        trial(seed, i, check_frame, seed, i, blob, eng, stats)
        if (i + 1) % 100 == 0:
            log(f"{i + 1}/{iters} frames ok")
    return {"frames": iters, "outcomes": dict(stats)}


def main() -> int:
    device, argv = split_device(sys.argv[1:])
    engine = "device"
    if "--engine" in argv:
        i = argv.index("--engine")
        engine = argv[i + 1]
        del argv[i : i + 2]
    arg = argv[0] if argv else "0"
    iters = int(argv[1]) if len(argv) > 1 else 200
    if os.path.exists(arg):
        trial(arg, 0, check_frame, arg, 0, open(arg, "rb").read(), Engines(device, engine),
              Counter())
        print("ok")
        return 0
    res = run(int(arg), iters, device, engine)
    print(f"all ok: {res}")
    return 0


if __name__ == "__main__":
    sys.exit(run_main(main))
