"""The port's size bounds (``container/bound.py``) against the JAX
package's on a grid of sizes and on mutated block headers: equal values."""

import struct

import numpy as np
import pytest

from bzip3_tpu.container import bound as jax_bound
from bzip3_tpu_torch.container import bound as port_bound

SIZES = [0, 1, 63, 64, 1000, 65 * 1024 - 1, 65 * 1024, 1 << 20, 16 << 20, 511 << 20,
         (511 << 20) + 1, 2**31 - 1]


@pytest.mark.parametrize("name", ["bound", "bwt_bound", "min_memory_needed",
                                  "validate_block_size"])
def test_size_functions_equal_jax(name):
    for n in SIZES:
        assert getattr(port_bound, name)(n) == getattr(jax_bound, name)(n), n


def _headers():
    """Block prefixes: short ones, literals, every model bit pattern with
    sizes around the original size, and random bytes (seeded)."""
    rng = np.random.default_rng(11)
    out = [b"", b"\x00" * 8, struct.pack("<Ii", 7, -1), struct.pack("<Ii", 7, -1) + b"x"]
    for model in range(8):
        for lzp, rle in ((-5, 10), (0, 0), (100, 200), (5000, 4000), (2**31 - 1, 1)):
            full = struct.pack("<IiB", 1, 5, model) + struct.pack("<ii", lzp, rle)
            out += [full[:k] for k in (9, 13, 17, 21, 25)]
    out += [bytes(rng.integers(0, 256, int(k), dtype=np.uint8))
            for k in rng.integers(0, 40, 200)]
    return out


@pytest.mark.parametrize("orig_size", [-1, 0, 100, 4500, 1 << 20])
def test_orig_size_sufficient_for_decode_equals_jax(orig_size):
    for block in _headers():
        assert port_bound.orig_size_sufficient_for_decode(block, orig_size) == \
            jax_bound.orig_size_sufficient_for_decode(block, orig_size), (block, orig_size)


def test_header_length_quirk_kept():
    # model 6 needs 9 + 8 + 16 = 33 bytes by the reference's formula: a
    # 17-byte header whose fields are all present still reads as short
    hdr = struct.pack("<IiB", 1, 5, 6) + struct.pack("<ii", 10, 10)
    assert port_bound.orig_size_sufficient_for_decode(hdr, 100) == -1
    assert port_bound.orig_size_sufficient_for_decode(hdr + b"\x00" * 16, 100) == 1
