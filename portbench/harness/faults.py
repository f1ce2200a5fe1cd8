"""Faults planted under the timed path, and the control: what ``correct``
must come out false on.  None of them runs in the benchmark's own runs;
``portbench/control.py`` runs them on the card, and
``portbench/tests/test_portbench_correct.py`` on the CPU.

Faults (wrappers of the program's engine):

- ``unchanged``: encode returns each block as it came in (a step that
  returns its state unchanged).
- ``half``: encode codes the first half of each batch and leaves out the
  rest (half of the batch left out).
- ``answer``: one byte of one compressed block is altered where the
  encode produces it (an answer altered where it is produced).
- ``decoded``: one byte of one decoded block is altered where the decode
  produces it.

The exchange between chips does not exist in a one-card cell.

The control (``split``): the program at half the block size, framed as
the cell's block size.  The stream stays lossless and decodable, and is
the faster one a later change might be tempted by (twice the rows, each
row half as long on a card that codes a row serially), but it is not
bzip3's stream at the cell's block size: it breaks the configuration's
byte-identity guarantee.
"""

from __future__ import annotations

import io
import struct
import time


class _Wrap:
    def __init__(self, engine):
        self.engine = engine
        self.stages = engine.stages

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def encode_blocks(self, blocks, block_size=None):
        return self.engine.encode_blocks(blocks, block_size)

    def decode_blocks(self, pairs, block_size):
        return self.engine.decode_blocks(pairs, block_size)


class Unchanged(_Wrap):
    def encode_blocks(self, blocks, block_size=None):
        return list(blocks)


class Half(_Wrap):
    def encode_blocks(self, blocks, block_size=None):
        return self.engine.encode_blocks(blocks[: max(1, len(blocks) // 2)], block_size)


def _flip(b: bytes, at: int) -> bytes:
    at = min(max(at, 0), len(b) - 1)
    return b[:at] + bytes([b[at] ^ 0x5A]) + b[at + 1 :]


class Answer(_Wrap):
    """The middle byte of the middle block's payload, xored."""

    def encode_blocks(self, blocks, block_size=None):
        out = self.engine.encode_blocks(blocks, block_size)
        i = len(out) // 2
        out[i] = _flip(out[i], len(out[i]) // 2)
        return out


class Decoded(_Wrap):
    def decode_blocks(self, pairs, block_size):
        out = self.engine.decode_blocks(pairs, block_size)
        i = len(out) // 2
        out[i] = _flip(out[i], len(out[i]) // 2)
        return out


class Flaky(Answer):
    calls = 0

    def encode_blocks(self, blocks, block_size=None):
        self.calls += 1
        if self.calls % 2:
            return self.engine.encode_blocks(blocks, block_size)
        return super().encode_blocks(blocks, block_size)


FAULTS = {"unchanged": Unchanged, "half": Half, "answer": Answer, "decoded": Decoded,
          "flaky": Flaky}


def split_round_trip(data: bytes, block_size: int, engine, spans, sync) -> dict:
    """The control's op: blocks of half ``block_size`` coded by the
    program in one batch, framed under a header of ``block_size``, then
    ``decompress_file`` of that stream."""
    from bzip3_tpu_torch.container.stream import decompress_file

    half = block_size // 2
    pieces = [data[i : i + half] for i in range(0, len(data), half)]
    op = {"in_bytes": len(data), "enc_s": 0.0, "dec_s": 0.0, "stream": b"", "decoded": b"",
          "error": None}
    try:
        t0 = time.perf_counter()
        with spans.span("op.encode"):
            coded = engine.encode_blocks(pieces, half)
            sync()
        op["enc_s"] = time.perf_counter() - t0
        out = io.BytesIO()
        out.write(b"BZ3v1" + struct.pack("<I", block_size))
        for p, c in zip(pieces, coded):
            out.write(struct.pack("<II", len(c), len(p)) + c)
        op["stream"] = out.getvalue()
        dec = io.BytesIO()
        t0 = time.perf_counter()
        with spans.span("op.decode"):
            decompress_file(io.BytesIO(op["stream"]), dec, engine=engine,
                            batch_size=len(pieces))
            sync()
        op["dec_s"] = time.perf_counter() - t0
        op["decoded"] = dec.getvalue()
    except Exception as e:
        op["error"] = f"{type(e).__name__}: {e}"
    return op
