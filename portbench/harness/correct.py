"""What decides ``correct``: the window's outputs against the file the
benchmark made and against the plain reference (``portbench.reference``).

Every number compared is exact, so every limit is 0:

- ``failed_ops``: ops whose compress or decompress raised.
- ``roundtrip_bytes_wrong``: over every op, the bytes of the decoded file
  that differ from the file, plus any difference in length.
- ``streams_differing``: ops whose stream differs from the first op's.
- On the first op's stream (the first op that produced one), against
  the reference:
  ``framing_fields_wrong``: the file header's magic and block size, the
  number of blocks and each block's original size against the CLI's
  framing of the file;
  ``crc_fields_wrong``: every block's CRC-32C field;
  ``rle_fields_wrong``: every block's RLE bit of the model byte and RLE
  size against the reference's RLE of the block (a block stored literal
  counts when it has ``SMALL_BLOCK`` bytes or more);
  ``block_fields_wrong``: the BWT index, the model byte and the LZP and
  RLE sizes of the deep-checked blocks against the reference's encode of
  each (RLE, LZP, suffix sort);
  ``cm_prefix_bytes_wrong``: each deep-checked block's CM payload against
  the reference coder's payload of the first ``CM_PREFIX`` bytes of the
  reference's BWT output (less the coder's 4 flush bytes, which the
  coder never changes afterwards).

The deep-checked blocks are the block with the longest CM row in the
stream (drawn from the seed among equals) and ``DEEP_DRAWN`` more drawn
from the seed.  The reference runs once the window has closed, on the
host, in ``WORKERS`` processes: one a deep-checked block, and the CRC and
RLE of every block in groups of ``GROUP`` blocks.
"""

from __future__ import annotations

import multiprocessing
import random
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..reference import stream as ref

DEEP_DRAWN = 2
CM_PREFIX = 256 << 10
GROUP = 4
WORKERS = 6
SALT = 0x5EED
REFERENCE_CHECKS = ("framing_fields_wrong", "crc_fields_wrong", "rle_fields_wrong",
                    "block_fields_wrong", "cm_prefix_bytes_wrong")


def bytes_wrong(got: bytes, want: bytes) -> int:
    """Bytes of ``got`` that differ from ``want``, plus the length gap."""
    if got == want:
        return 0
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def deep_blocks(seed: int, rows: list[int]) -> list[int]:
    """The deep-checked blocks for ``seed``, given each block's CM row
    length as the stream states it: the longest row first."""
    rng = random.Random(seed ^ SALT)
    top = max(rows)
    longest = rng.choice([i for i, r in enumerate(rows) if r == top])
    rest = [i for i in range(len(rows)) if i != longest]
    return [longest] + sorted(rng.sample(rest, min(len(rest), DEEP_DRAWN)))


def reference_checks(data: bytes, stream: bytes, block_size: int, seed: int) -> dict[str, int]:
    bounds = ref.split(len(data), block_size)
    try:
        magic, bs, blocks = ref.parse(stream)
    except ValueError:
        return {k: max(1, len(bounds)) for k in REFERENCE_CHECKS}
    out = dict.fromkeys(REFERENCE_CHECKS, 0)
    out["framing_fields_wrong"] = (
        int(magic != ref.MAGIC) + int(bs != block_size) + abs(len(blocks) - len(bounds))
        + sum(b["osize"] != e - s for b, (s, e) in zip(blocks, bounds)))
    pieces = [data[s:e] for s, e in bounds[: len(blocks)]]
    blocks = blocks[: len(pieces)]
    deep = deep_blocks(seed, [ref.size_before_bwt(b) for b in blocks])
    groups = [pieces[i : i + GROUP] for i in range(0, len(pieces), GROUP)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(WORKERS, len(deep) + len(groups)), mp_context=ctx) as pool:
        heads = [pool.submit(ref.encode_head, pieces[i], CM_PREFIX) for i in deep]
        light = [f for g in [pool.submit(ref.light_fields, g) for g in groups] for f in g.result()]
        heads = [h.result() for h in heads]
    for got, (crc, rle_size) in zip(blocks, light):
        out["crc_fields_wrong"] += got["crc"] != crc
        if got["model"] is None:  # stored literal: only a block under SMALL_BLOCK bytes is
            out["rle_fields_wrong"] += got["osize"] >= ref.SMALL_BLOCK
            continue
        kept = rle_size < got["osize"]
        out["rle_fields_wrong"] += (bool(got["model"] & ref.RLE_KEPT) != kept
                                    or got["rle"] != (rle_size if kept else -1))
    for i, want in zip(deep, heads):
        got = blocks[i]
        out["block_fields_wrong"] += sum(got[k] != want[k] for k in ("index", "model", "lzp", "rle"))
        body = stream[got["payload_at"] : got["at"] + got["csize"]]
        pre = want["payload_prefix"]
        out["cm_prefix_bytes_wrong"] += bytes_wrong(body[: len(pre)], pre)
    return out


def checks(data: bytes, ops: list[dict], block_size: int, seed: int) -> dict[str, tuple[int, int]]:
    """{name: (value, limit)} of every number compared.  The streams
    compared are those the ops produced, whether or not their decode
    then failed."""
    made = [op for op in ops if op["stream"]]
    out = {
        "failed_ops": sum(op["error"] is not None for op in ops),
        "roundtrip_bytes_wrong": sum(bytes_wrong(op["decoded"], data) for op in ops
                                     if op["error"] is None),
        "streams_differing": sum(op["stream"] != made[0]["stream"] for op in made),
    }
    if made:
        out.update(reference_checks(data, made[0]["stream"], block_size, seed))
    else:
        out.update(dict.fromkeys(REFERENCE_CHECKS, 1))
    return {k: (v, 0) for k, v in out.items()}
