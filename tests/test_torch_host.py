"""The port's host passes (``ops/host``: CRC32-C, RLE, LZP and the BWT
in its own C++) against the oracles of ``ops/ref``, byte for byte, and
its BWT against the native runtime's (``ops/native``).

The LZP cases target the format's quirks: the ``heur`` rejection, the
word-granular match extension with its 0..3-byte tail, base-254 match
lengths, 0xF2 escapes with and without a live prediction, the 72-byte
minimum and the output cap.
"""

import numpy as np
import pytest

from bzip3_tpu.ops import native
from bzip3_tpu.ops.ref import bwt as ref_bwt
from bzip3_tpu.ops.ref import crc32, lzp_decode, lzp_encode, rle_decode, rle_encode
from bzip3_tpu.ops.ref.lzp import MATCH
from bzip3_tpu_torch.ops import host

RNG = np.random.default_rng(42)
TEXT = (b"the quick brown fox jumps over the lazy dog. " * 40)[:1600]


def _heur():
    out = b""
    for i in range(40):
        out += b"CTXT" + bytes([i]) * 9
    return out


CASES = {
    "empty": b"",
    "one": b"\x07",
    "text": TEXT,
    "long_match": TEXT[:200] + b"X" * 30 + TEXT[:200] + b"Y" * 30 + TEXT[:500],
    "big_run": b"A" * 700 + b"B" * 11 + b"A" * 700,
    "escape": bytes([MATCH]) * 90 + TEXT[:300] + bytes([MATCH, MATCH, 1, 2, MATCH]),
    "random": bytes(RNG.integers(0, 256, 1500, dtype=np.uint8)),
    "periodic": b"abcdefgh" * 200,
    "heur": _heur(),
    "vlong": (TEXT * 20)[:12000],
    "z71": b"Z" * 71,
    "z72": b"Z" * 72,
    "runs_255": b"\x00" * 600 + b"\x01" * 255 + b"\x02" * 256,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_passes_match_oracle(name):
    data = CASES[name]
    assert host.crc32(data) == crc32(data)

    r = host.rle_encode(data)
    assert r == rle_encode(data)
    assert host.rle_decode(r, len(data)) == data == rle_decode(r, len(data))

    lz = host.lzp_encode(data)
    assert lz == lzp_encode(data)
    if lz is not None:
        bnd = len(data) + 64
        assert host.lzp_decode(lz, bnd) == data == lzp_decode(lz, bnd)


def test_crc32_known_vector():
    assert host.crc32(b"123456789") == 0xACDD2C68
    assert host.crc32(b"") == 1


def test_malformed_streams_match_oracle():
    assert host.rle_decode(b"\x00" * 31, 5) is None
    bad_rle = bytes([1] + [0] * 31) + b"\x00"  # gated byte 0 with its run cut off
    assert host.rle_decode(bad_rle, 5) == rle_decode(bad_rle, 5)
    e = lzp_encode(TEXT + TEXT[:300])
    assert MATCH in e
    cut = e[: e.index(bytes([MATCH])) + 1]  # stream ends right after a match token
    assert host.lzp_decode(cut, 4096) == lzp_decode(cut, 4096)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_bwt_matches_native_and_oracle(name):
    data = CASES[name]
    u, idx = host.bwt_forward(data)
    assert (u, idx) == native.bwt_forward(data) == ref_bwt.bwt_forward(data)
    assert host.bwt_inverse(u, idx) == data == native.bwt_inverse(u, idx)


def test_host_bwt_large_block_paths():
    """Past 2^18 bytes the inverse composes four LF steps a node (the
    quad merge); the forward recursion runs on a 3-letter alphabet."""
    data = RNG.integers(0, 3, (1 << 18) + 777, dtype=np.uint8).tobytes()
    u, idx = host.bwt_forward(data)
    assert (u, idx) == native.bwt_forward(data)
    assert host.bwt_inverse(u, idx) == data


def test_host_bwt_inverse_rejects_an_index_out_of_range():
    u, idx = host.bwt_forward(TEXT)
    for bad in (0, -1, len(TEXT) + 1):
        assert host.bwt_inverse(u, bad) is None
        assert native.bwt_inverse(u, bad) is None
    assert host.bwt_inverse(b"", 1) is None
    assert host.bwt_inverse(b"q", 0) is None
    assert host.bwt_inverse(b"q", 1) == b"q"
