"""The CLI's stream format (src/main.c:157-482) and a block's header
(src/libbz3.c:585-654), for checking a stream against the reference.

    "BZ3v1" + block_size:u32le
    then per block: [csize:u32le][osize:u32le][block]
    block = [crc32:u32le][bwt_idx:i32le][model:u8]([lzp_size:i32le])([rle_size:i32le])[CM payload]

A block under 64 bytes is stored literal: bwt_idx -1 and the raw bytes.
Model bit 2: LZP kept; bit 4: RLE kept.  The multi-worker CLI (-j 2 and
up, as a batch of several blocks) reads before it tests for the end of
the input, so an input that is a whole number of blocks gets one empty
block more.
"""

import itertools
import struct

from . import bwt, cm, lzp, rle

MAGIC = b"BZ3v1"
SMALL_BLOCK = 64
LZP_KEPT, RLE_KEPT = 2, 4


def split(size: int, block_size: int, multi_worker: bool = True) -> list[tuple[int, int]]:
    """The (start, stop) of each block the CLI reads from a file."""
    out = [(s, min(size, s + block_size)) for s in range(0, size, block_size)]
    if multi_worker and size % block_size == 0:
        out.append((size, size))
    return out


def parse(stream: bytes) -> tuple[bytes, int, list[dict]]:
    """(magic, block size, blocks): each block's osize, csize, offset of
    its block bytes and header fields.  Raises ValueError on a stream
    that ends inside a header or a block."""
    if len(stream) < 9:
        raise ValueError("stream shorter than its header")
    magic, bs = stream[:5], struct.unpack_from("<I", stream, 5)[0]
    out, at = [], 9
    while at < len(stream):
        if at + 8 > len(stream):
            raise ValueError(f"stream ends inside the header of block {len(out)}")
        csize, osize = struct.unpack_from("<II", stream, at)
        at += 8
        if at + csize > len(stream) or csize < 8:
            raise ValueError(f"block {len(out)} runs past the stream or is too short")
        crc, idx = struct.unpack_from("<Ii", stream, at)
        blk = {"osize": osize, "csize": csize, "at": at, "crc": crc, "index": idx,
               "model": None, "lzp": -1, "rle": -1, "payload_at": at + 8}
        if idx != -1:
            model = stream[at + 8]
            off = at + 9
            lzp_size = rle_size = -1
            if model & LZP_KEPT:
                lzp_size = struct.unpack_from("<i", stream, off)[0]
                off += 4
            if model & RLE_KEPT:
                rle_size = struct.unpack_from("<i", stream, off)[0]
                off += 4
            blk.update(model=model, lzp=lzp_size, rle=rle_size, payload_at=off)
        out.append(blk)
        at += csize
    return magic, bs, out


def size_before_bwt(blk: dict) -> int:
    """The CM row's length: LZP's output, else RLE's, else the block's."""
    if blk["index"] == -1:
        return 0
    if blk["model"] & LZP_KEPT:
        return blk["lzp"]
    if blk["model"] & RLE_KEPT:
        return blk["rle"]
    return blk["osize"]


def encode_head(data: bytes, cm_prefix: int) -> dict:
    """A block's header fields as bzip3 writes them (all but the CRC,
    which ``crc32_blocks`` gives for many blocks at once), and the CM payload of
    the first ``cm_prefix`` bytes of its BWT output less the coder's 4
    flush bytes (a prefix of the whole payload)."""
    if len(data) < SMALL_BLOCK:
        return {"index": -1, "model": None, "lzp": -1, "rle": -1, "payload_prefix": data}
    model, lzp_size, rle_size, cur = 0, -1, -1, data
    r = rle.rle_encode(cur)
    if len(r) < len(cur):
        cur, rle_size, model = r, len(r), model | RLE_KEPT
    z = lzp.lzp_encode(cur)
    if z is not None and len(z) < len(cur):
        cur, lzp_size, model = z, len(z), model | LZP_KEPT
    u, index = bwt.bwt_forward(cur)
    return {"index": index, "model": model, "lzp": lzp_size, "rle": rle_size,
            "payload_prefix": cm.cm_encode(u[:cm_prefix])[:-4]}


def light_fields(blocks: list[bytes]) -> list[tuple[int, int]]:
    """(CRC-32C, RLE size) of each block: the fields the reference checks
    on every block."""
    from .crc32 import crc32_blocks

    ends = list(itertools.accumulate(len(b) for b in blocks))
    crcs = crc32_blocks(b"".join(blocks), [(e - len(b), e) for b, e in zip(blocks, ends)])
    return [(c, rle.rle_size(b)) for c, b in zip(crcs, blocks)]
