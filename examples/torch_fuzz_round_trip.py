#!/usr/bin/env python
"""Round-trip fuzzer for the PyTorch/CUDA port (the port's counterpart of
``fuzz_round_trip.py``; cf. the reference's examples/fuzz-round-trip.c).

Feeds random and structured inputs through encode -> decode on the
engine that ``FUZZ_ENGINE`` names (the port's ``device``, ``sharded``,
``native``, ``hybrid``, ``oracle`` or ``auto``; default ``auto``) and
stops at the first mismatch, with its seed and index.  Each stream must
also equal the native engine's, byte for byte.  The device, sharded and
hybrid engines run on ``cuda`` unless ``--device cpu`` is given.  With a
file argument the file is the input (AFL-style one shot, so that
external fuzzers can drive it).

    FUZZ_ENGINE=device python examples/torch_fuzz_round_trip.py [seed|path] [iterations] [--device cpu]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_harness import require, run_main, split_device, sync, trial  # noqa: E402

from bzip3_tpu_torch.engines import NativeEngine, get_engine  # noqa: E402


def jax_inputs(seed: int, iters: int) -> list[bytes]:
    """The JAX harness's inputs for ``seed``, draw for draw: random bytes,
    a 3-letter alphabet, one repeated byte, a repeated 17-byte word, and
    63-66 random bytes around the literal boundary."""
    rng = np.random.default_rng(seed)
    out = []
    for it in range(iters):
        kind = it % 5
        n = int(rng.integers(0, 5000))
        if kind == 0:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif kind == 1:
            data = rng.integers(0, 3, n, dtype=np.uint8).tobytes()
        elif kind == 2:
            data = bytes(rng.integers(0, 256, 1, dtype=np.uint8)) * n
        elif kind == 3:
            word = rng.integers(0, 256, 17, dtype=np.uint8).tobytes()
            data = (word * (n // 17 + 1))[:n]
        else:
            data = rng.integers(0, 256, 63 + (it % 4), dtype=np.uint8).tobytes()
        out.append(data)
    return out


def one_input(seed, index, data: bytes, engine, nat, device) -> None:
    bs = max(65 * 1024, len(data))
    enc = engine.encode_blocks([data], bs)[0]
    want = nat.encode_blocks([data], bs)[0]
    require(enc == want, seed, index, f"stream differs from the native engine's "
            f"({len(data)} bytes, {len(enc)} against {len(want)})")
    dec = engine.decode_blocks([(enc, len(data))], bs)[0]
    sync(device)
    require(dec == data, seed, index, f"round-trip mismatch on {len(data)} bytes")


def run(seed: int = 0, iters: int = 200, engine: str = "auto", device="cuda",
        log=print) -> dict:
    eng = get_engine(engine, device=device)
    nat = NativeEngine(0)
    for i, data in enumerate(jax_inputs(seed, iters)):
        trial(seed, i, one_input, seed, i, data, eng, nat, device)
        if (i + 1) % 50 == 0:
            log(f"{i + 1}/{iters} ok")
    return {"engine": engine, "inputs": iters}


def main() -> int:
    device, argv = split_device(sys.argv[1:])
    arg = argv[0] if argv else "0"
    iters = int(argv[1]) if len(argv) > 1 else 200
    name = os.environ.get("FUZZ_ENGINE", "auto")
    if os.path.exists(arg):
        trial(arg, 0, one_input, arg, 0, open(arg, "rb").read(),
              get_engine(name, device=device), NativeEngine(0), device)
        print("ok")
        return 0
    run(int(arg), iters, name, device)
    print("all ok")
    return 0


if __name__ == "__main__":
    sys.exit(run_main(main))
