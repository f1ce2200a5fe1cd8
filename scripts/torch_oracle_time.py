#!/usr/bin/env python3
"""Times the port's oracle engine (the block codec over ``ops/ref``) on
the CPU, beside the block codec over the plain versions
(``block_stages("cpu")``) that the oracle engine ran on before it had a
spec of its own.

    python3 scripts/torch_oracle_time.py [--kib 16] [--plain]

One block of ``--kib`` KiB of ``bench.py``'s seeded text
(``examples/torch_harness.make_corpus``, seed 0): encode and decode
seconds, the stream checked to round-trip (and, with ``--plain``, equal
to the plain versions' stream, which takes ~40 s a way at 16 KiB).  One
JSON line; seconds on this machine's clock, no device used.  The CPU
seconds of the differential's oracle leg are in the ``oracle`` result of
``examples/torch_differential_engines.py``.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "examples")]

from torch_harness import make_corpus  # noqa: E402

from bzip3_tpu_torch.engines import OracleEngine  # noqa: E402
from bzip3_tpu_torch.models.block_codec import decode_block, encode_block  # noqa: E402
from bzip3_tpu_torch.ops.device.stages import block_stages  # noqa: E402

BLOCK = 1 << 20


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def time_text(kib: int, plain: bool) -> dict:
    data = make_corpus(kib * 1024, seed=0)
    eng = OracleEngine()
    enc, te = _timed(lambda: eng.encode_blocks([data], BLOCK)[0])
    dec, td = _timed(lambda: eng.decode_blocks([(enc, len(data))], BLOCK)[0])
    assert dec == data
    res = {"what": "oracle_engine", "bytes": len(data), "stream_bytes": len(enc),
           "encode_s": te, "decode_s": td}
    if plain:
        st = block_stages("cpu")
        penc, pte = _timed(encode_block, data, st)
        pdec, ptd = _timed(decode_block, penc, len(data), BLOCK, st)
        assert penc == enc and pdec == data
        res.update(plain_encode_s=pte, plain_decode_s=ptd)
    return res


def main() -> int:
    args = sys.argv[1:]
    kib = int(args[args.index("--kib") + 1]) if "--kib" in args else 16
    print(json.dumps(time_text(kib, "--plain" in args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
