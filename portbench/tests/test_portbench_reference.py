"""The reference's faster forms against the frozen copies of the port's
executable spec, and its framing."""

import json
import os
import random

import numpy as np
import pytest

from portbench import corpora
from portbench.reference import bwt, crc32, lzp, rle, stream

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases():
    rnd = random.Random(11)
    out = [b"", b"a", b"ab", b"aaaa", b"abababab", b"banana", bytes(1000), b"\xff" * 77 + b"\x00"]
    for _ in range(60):
        base = bytes(rnd.choice(b"ab\x00\xff\xf2") for _ in range(rnd.randint(1, 40)))
        out.append((base * rnd.randint(1, 60))[: rnd.randint(1, 3000)]
                   + bytes(rnd.getrandbits(8) for _ in range(rnd.randint(0, 40))))
    with open(os.path.join(PB, "traffic", "silesia-rt.json")) as f:
        t = json.load(f)
    d = corpora.generate(t, 3, "cpu", scale=0.002)
    out += [d[o : o + n] for o, n, _ in corpora.layout(t, 0.002)[1]]
    return out


CASES = cases()


@pytest.mark.parametrize("i", range(len(CASES)))
def test_fast_forms_equal_plain(i):
    c = CASES[i]
    a = np.frombuffer(c, np.uint8)
    assert np.array_equal(bwt.suffix_array(a), bwt.suffix_array_plain(a))
    assert rle.rle_encode(c) == rle.rle_encode_plain(c)
    assert rle.rle_size(c) == len(rle.rle_encode_plain(c))
    assert lzp.lzp_encode(c) == lzp.lzp_encode_plain(c)


def test_crc_blocks():
    d = b"".join(CASES)
    bounds = [(0, 0), (0, 5000), (5000, 5000 + 3 * crc32.LANE + 17), (20000, len(d))]
    assert crc32.crc32_blocks(d, bounds) == [crc32.crc32(d[s:e]) for s, e in bounds]
    assert crc32.crc32(b"123456789", 0xFFFFFFFF) ^ 0xFFFFFFFF == 0xE3069283  # CRC-32C check value


def test_split_follows_the_cli():
    assert stream.split(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert stream.split(8, 4) == [(0, 4), (4, 8), (8, 8)]
    assert stream.split(8, 4, multi_worker=False) == [(0, 4), (4, 8)]
