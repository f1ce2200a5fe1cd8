"""Streaming file container: the ``bzip3`` CLI's on-disk format.

Layout (reference: process(), src/main.c:157-482):

    "BZ3v1" + block_size:u32le                      (9-byte file header)
    then per block: [csize:u32le][osize:u32le][payload]

There is no block count: the stream ends at EOF.  The decoder
validates both chunk sizes against bound(block_size) before decoding.
``test`` is decode without output; ``recover`` decodes what it can,
writes best-effort bytes for the blocks that fail, and goes on
(src/main.c:279-299).

The reads and writes are host spans ``container/<encode|decode>/<read|write>``
(``utils.profiling.host_span``): on the engine's timer where it has one
that is on, and ranges of a ``torch.profiler`` trace while one records.
"""

from __future__ import annotations

import struct
import sys
from typing import BinaryIO, Iterator

from .bound import MiB, bound, validate_block_size
from ..engines import DeviceEngine
from ..errors import Bz3Error, BZ3_ERR_MALFORMED_HEADER, BZ3_ERR_TRUNCATED_DATA
from ..models.block_codec import decode_block_recover
from ..utils.profiling import host_span

MAGIC = b"BZ3v1"
_U32 = struct.Struct("<I")


def write_file_header(out: BinaryIO, block_size: int) -> int:
    out.write(MAGIC)
    out.write(_U32.pack(block_size))
    return 9


def read_file_header(inp: BinaryIO, recover: bool = False) -> int:
    sig = inp.read(5)
    if sig != MAGIC:
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER, "invalid signature")
    raw = inp.read(4)
    if len(raw) != 4:
        raise Bz3Error(BZ3_ERR_TRUNCATED_DATA, "short header")
    block_size = _U32.unpack(raw)[0]
    if not validate_block_size(block_size):
        if recover:
            # recover mode goes on at the largest block size
            # (src/main.c:199-204)
            return 511 * MiB
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER, "invalid block size in header")
    return block_size


def iter_chunks(inp: BinaryIO, block_size: int,
                timer=None) -> Iterator[tuple[int, int, bytes]]:
    """Yield (csize, osize, payload) triples until EOF, each chunk's
    reads a span ``container/decode/read`` (``host_span`` on ``timer``)."""
    cap = bound(block_size)
    while True:
        with host_span(timer, "container/decode/read"):
            hdr = inp.read(4)
            if not hdr:
                return
            if len(hdr) != 4:
                raise Bz3Error(BZ3_ERR_TRUNCATED_DATA, "short chunk header")
            csize = _U32.unpack(hdr)[0]
            raw = inp.read(4)
            if len(raw) != 4:
                raise Bz3Error(BZ3_ERR_TRUNCATED_DATA, "short chunk header")
            osize = _U32.unpack(raw)[0]
            if csize > cap or osize > cap:
                raise Bz3Error(BZ3_ERR_MALFORMED_HEADER, "inconsistent chunk header")
            payload = inp.read(csize)
            if len(payload) != csize:
                raise Bz3Error(BZ3_ERR_TRUNCATED_DATA, "short chunk payload")
        yield csize, osize, payload


def compress_file(
    inp: BinaryIO,
    out: BinaryIO,
    block_size: int = 16 * MiB,
    engine=None,
    batch_size: int = 1,
    feof_block: bool | None = None,
    device="cuda",
) -> tuple[int, int]:
    """Stream-compress; returns (bytes_read, bytes_written).

    Up to ``batch_size`` blocks go to ``engine`` (default: a
    ``DeviceEngine`` on ``device``) together.

    ``feof_block``: the reference's MULTI-WORKER loop reads BEFORE
    checking feof (src/main.c:351-362), so with `-j >= 2` an input that
    is an exact multiple of the block size gets one trailing EMPTY block
    and an empty input gets one empty block, while the single-thread
    loop (src/main.c:237-255) emits neither.  Byte identity mirrors the
    quirk per the user's -j flag; None derives it from batch_size.
    """
    eng = engine if engine is not None else DeviceEngine(device)
    timer = getattr(eng, "timer", None)
    bytes_read = 0
    bytes_written = write_file_header(out, block_size)
    pending: list[bytes] = []

    def flush():
        nonlocal bytes_written
        if not pending:
            return
        payloads = eng.encode_blocks(pending, block_size)
        with host_span(timer, "container/encode/write"):
            for orig, payload in zip(pending, payloads):
                out.write(_U32.pack(len(payload)))
                out.write(_U32.pack(len(orig)))
                out.write(payload)
                bytes_written += 8 + len(payload)
        pending.clear()

    if feof_block is None:
        feof_block = batch_size >= 2
    while True:
        with host_span(timer, "container/encode/read"):
            chunk = inp.read(block_size)
        if not chunk and not feof_block:
            break
        bytes_read += len(chunk)
        pending.append(chunk)
        if len(pending) >= max(1, batch_size):
            flush()
        if len(chunk) < block_size:
            break
    flush()
    return bytes_read, bytes_written


def decompress_file(
    inp: BinaryIO,
    out: BinaryIO | None,
    engine=None,
    batch_size: int = 1,
    device="cuda",
    recover: bool = False,
    test_only: bool = False,
) -> tuple[int, int]:
    """Stream-decompress, test or recover; returns (read, written).

    The engine receives the block size parsed from the file header.  In
    recover mode a batch that raises is decoded again block by block
    through the engine, and a block that still fails goes to
    ``decode_block_recover`` over the engine's stage namespace
    (``engine.stages``), which writes what its stage chain produced.
    ``test_only`` writes nothing and counts the bytes it would write."""
    eng = engine if engine is not None else DeviceEngine(device)
    timer = getattr(eng, "timer", None)
    block_size = read_file_header(inp, recover=recover)
    bytes_read = 9
    bytes_written = 0
    pending: list[tuple[bytes, int]] = []

    def recover_one(payload: bytes, osize: int) -> bytes:
        try:
            return eng.decode_blocks([(payload, osize)], block_size)[0]
        except Bz3Error:
            pass
        data, ok = decode_block_recover(payload, osize, block_size, eng.stages)
        if not ok:
            print("bzip3: Writing invalid block.", file=sys.stderr)
        return data

    def flush():
        nonlocal bytes_written
        if not pending:
            return
        try:
            results = eng.decode_blocks(list(pending), block_size)
        except Bz3Error:
            if not recover:
                raise
            results = [recover_one(p, o) for p, o in pending]
        with host_span(timer, "container/decode/write"):
            for (_, osize), data in zip(pending, results):
                if out is not None and not test_only:
                    out.write(data[:osize])
                    bytes_written += min(len(data), osize)
                else:
                    bytes_written += osize
        pending.clear()

    for csize, osize, payload in iter_chunks(inp, block_size, timer):
        bytes_read += 8 + csize
        pending.append((payload, osize))
        if len(pending) >= max(1, batch_size):
            flush()
    flush()
    return bytes_read, bytes_written


def test_file(inp: BinaryIO, engine=None, batch_size: int = 1,
              device="cuda") -> tuple[int, int]:
    """Decode without output; raises on the first bad block."""
    return decompress_file(inp, None, engine, batch_size, device, test_only=True)


def recover_file(inp: BinaryIO, out: BinaryIO, engine=None, batch_size: int = 1,
                 device="cuda") -> tuple[int, int]:
    """Decode what can be decoded, best-effort bytes for the rest."""
    return decompress_file(inp, out, engine, batch_size, device, recover=True)
