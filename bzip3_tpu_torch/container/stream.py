"""Streaming file container: the ``bzip3`` CLI's on-disk format.

Layout (reference: process(), src/main.c:157-482):

    "BZ3v1" + block_size:u32le                      (9-byte file header)
    then per block: [csize:u32le][osize:u32le][payload]

There is no block count: the stream ends at EOF.  The decoder
validates both chunk sizes against bound(block_size) before decoding.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator

from .bound import MiB, bound, validate_block_size
from ..engines import DeviceEngine
from ..errors import Bz3Error, BZ3_ERR_MALFORMED_HEADER, BZ3_ERR_TRUNCATED_DATA

MAGIC = b"BZ3v1"
_U32 = struct.Struct("<I")


def write_file_header(out: BinaryIO, block_size: int) -> int:
    out.write(MAGIC)
    out.write(_U32.pack(block_size))
    return 9


def read_file_header(inp: BinaryIO) -> int:
    sig = inp.read(5)
    if sig != MAGIC:
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER, "invalid signature")
    raw = inp.read(4)
    if len(raw) != 4:
        raise Bz3Error(BZ3_ERR_TRUNCATED_DATA, "short header")
    block_size = _U32.unpack(raw)[0]
    if not validate_block_size(block_size):
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER, "invalid block size in header")
    return block_size


def iter_chunks(inp: BinaryIO, block_size: int) -> Iterator[tuple[int, int, bytes]]:
    """Yield (csize, osize, payload) triples until EOF."""
    cap = bound(block_size)
    while True:
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
    bytes_read = 0
    bytes_written = write_file_header(out, block_size)
    pending: list[bytes] = []

    def flush():
        nonlocal bytes_written
        if not pending:
            return
        for orig, payload in zip(pending, eng.encode_blocks(pending, block_size)):
            out.write(_U32.pack(len(payload)))
            out.write(_U32.pack(len(orig)))
            out.write(payload)
            bytes_written += 8 + len(payload)
        pending.clear()

    if feof_block is None:
        feof_block = batch_size >= 2
    while True:
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
    out: BinaryIO,
    engine=None,
    batch_size: int = 1,
    device="cuda",
) -> tuple[int, int]:
    """Stream-decompress; returns (bytes_read, bytes_written).

    The engine receives the block size parsed from the file header."""
    eng = engine if engine is not None else DeviceEngine(device)
    block_size = read_file_header(inp)
    bytes_read = 9
    bytes_written = 0
    pending: list[tuple[bytes, int]] = []

    def flush():
        nonlocal bytes_written
        if not pending:
            return
        for (_, osize), data in zip(pending, eng.decode_blocks(list(pending), block_size)):
            out.write(data[:osize])
            bytes_written += min(len(data), osize)
        pending.clear()

    for csize, osize, payload in iter_chunks(inp, block_size):
        bytes_read += 8 + csize
        pending.append((payload, osize))
        if len(pending) >= max(1, batch_size):
            flush()
    flush()
    return bytes_read, bytes_written
