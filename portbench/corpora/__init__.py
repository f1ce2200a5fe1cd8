"""The one general generator of the benchmark's traffic.

A traffic file (``portbench/traffic/<name>.json``) lists the members of
the file a cell round-trips, each with its size in bytes, its class and
the class's parameters.  ``generate`` makes the file from ``--seed``:
member by member, in chunks of ``CHUNK_BYTES``, each chunk from its own
``torch.Generator`` seeded by (seed, member, chunk), on the card when
given one, in a few large tensor calls (no per-word Python loop).

The classes (``CLASSES``) and their parameters:

- ``pieces``: words of a seeded vocabulary, each followed by a separator,
  drawn with Zipf frequencies (``bench.py``'s ``make_corpus`` text, and
  markup, source and machine code through other tables).
- ``lines``: records of fields in a fixed order, each field drawn from its
  own table (the access-log lines of ``chip_smoke.py``'s ``log_corpus``,
  and the repeated record lines of a chemical database).
- ``sparse``: short random records between runs of zero bytes
  (``chip_smoke.py``'s ``sparse_block``).
- ``records``: fixed-width binary records of typed fields.
- ``image``: 16-bit little-endian samples of a smooth field with noise.

The tables a class draws from (vocabularies, paths, agents) come from the
member's ``table_seed``, not from ``--seed``: every seed gives the same
kind of file with the same sizes, and only the draws differ.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import classes

CHUNK_BYTES = 32 << 20
CLASSES = {
    "pieces": classes.pieces,
    "lines": classes.lines,
    "sparse": classes.sparse,
    "records": classes.records,
    "image": classes.image,
}


def chunk_seed(seed: int, member: int, chunk: int) -> int:
    """A 63-bit seed for one chunk of one member, from the run's seed."""
    h = hashlib.sha256(f"{seed}/{member}/{chunk}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def member_sizes(traffic: dict, scale: float = 1.0) -> list[int]:
    """Each member's bytes, scaled down for a test (never below 1 KiB)."""
    sizes = [int(m["bytes"]) for m in traffic["members"]]
    if scale == 1.0:
        return sizes
    return [max(1024, int(s * scale)) for s in sizes]


def tar_header(name: str, size: int) -> bytes:
    """A POSIX ustar header of a regular file (mode 0644, mtime 0)."""
    h = bytearray(512)
    for off, val in ((0, name.encode()), (100, b"0000644\0"), (108, b"0000000\0"),
                     (116, b"0000000\0"), (124, b"%011o\0" % size), (136, b"00000000000\0"),
                     (156, b"0"), (257, b"ustar\x0000")):
        h[off : off + len(val)] = val
    h[148:156] = b" " * 8
    h[148:156] = b"%06o\0 " % sum(h)
    return bytes(h)


def layout(traffic: dict, scale: float = 1.0) -> tuple[int, list[tuple[int, int, bytes]]]:
    """(file bytes, [(member offset, member bytes, header before it)]): the
    members one after another, or with ``"container": "tar"`` inside a tar
    archive (a header each, 512-byte padding, two zero blocks at the end,
    the whole padded to 10,240-byte records, as GNU tar writes it)."""
    tar = traffic.get("container") == "tar"
    pos, out = 0, []
    for m, size in zip(traffic["members"], member_sizes(traffic, scale)):
        head = tar_header(m["name"], size) if tar else b""
        pos += len(head)
        out.append((pos, size, head))
        pos += -(-size // 512) * 512 if tar else size
    if tar:
        pos = -(-(pos + 1024) // 10240) * 10240
    return pos, out


def generate(traffic: dict, seed: int, device="cpu", scale: float = 1.0) -> bytes:
    """The traffic's file for ``seed``."""
    total, members = layout(traffic, scale)
    buf = np.zeros(total, np.uint8)
    for mi, (member, (off, size, head)) in enumerate(zip(traffic["members"], members)):
        buf[off - len(head) : off] = np.frombuffer(head, np.uint8)
        make = CLASSES[member["class"]](member.get("params", {}), member.get("table_seed", 0))
        for ci, at in enumerate(range(0, size, CHUNK_BYTES)):
            want = min(CHUNK_BYTES, size - at)
            gen = torch.Generator(device=device)
            gen.manual_seed(chunk_seed(seed, mi, ci))
            out = make(want, gen, torch.device(device))
            if out.numel() < want:
                raise RuntimeError(f"class {member['class']} made {out.numel()} of {want} bytes")
            buf[off + at : off + at + want] = out[:want].cpu().numpy()
    return buf.tobytes()
