"""The measured window: round trips of one file, back to back.

Each op compresses the file with ``compress_file`` into memory, then
decompresses that stream with ``decompress_file``, both on one engine
with ``batch_size`` = the file's blocks, each call ending in a
synchronise of the card.  Ops start until ``seconds`` have passed; an op
that has started is finished and counted.  Outputs are kept for the
checks after the window."""

from __future__ import annotations

import io
import time


def blocks_of(size: int, block_size: int) -> int:
    return max(1, -(-size // block_size))


def round_trip(data: bytes, block_size: int, engine, spans, sync) -> dict:
    """One op: (encode s, decode s, stream, decoded bytes, error)."""
    from bzip3_tpu_torch.container.stream import compress_file, decompress_file

    batch = blocks_of(len(data), block_size)
    op = {"in_bytes": len(data), "enc_s": 0.0, "dec_s": 0.0, "stream": b"", "decoded": b"",
          "error": None}
    try:
        out = io.BytesIO()
        with spans.span("op.encode"):
            t0 = time.perf_counter()
            compress_file(io.BytesIO(data), out, block_size, engine=engine, batch_size=batch)
            sync()
            op["enc_s"] = time.perf_counter() - t0
        op["stream"] = out.getvalue()
        del out
        dec = io.BytesIO()
        with spans.span("op.decode"):
            t0 = time.perf_counter()
            decompress_file(io.BytesIO(op["stream"]), dec, engine=engine, batch_size=batch)
            sync()
            op["dec_s"] = time.perf_counter() - t0
        op["decoded"] = dec.getvalue()
    except Exception as e:  # an op that fails is counted as failed, not fatal
        op["error"] = f"{type(e).__name__}: {e}"
    return op


def run(data: bytes, block_size: int, engine, spans, sync, seconds: float,
        op=None, min_ops: int = 1) -> tuple[list[dict], float, float]:
    """(ops, window start, window end) on the host clock; ``op`` replaces
    ``round_trip``; at least ``min_ops`` ops run."""
    op = op or round_trip
    ops = []
    start = time.perf_counter()
    while len(ops) < min_ops or time.perf_counter() - start < seconds:
        ops.append(op(data, block_size, engine, spans, sync))
    return ops, start, time.perf_counter()
