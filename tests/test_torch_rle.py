"""The port's batched mRLE (``ops/device/rle.py``, tensor code) against
the JAX package's ``rle_encode_batch`` / ``rle_decode_batch`` and the
oracle ``ops/ref/rle.py``.

Byte exact: tolerance 0.  The JAX package has no Pallas kernel for RLE,
so this tensor code is the port's version on the card too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bzip3_tpu.ops.device.rle import rle_decode_batch as jax_decode
from bzip3_tpu.ops.device.rle import rle_encode_batch as jax_encode
from bzip3_tpu.ops.ref.rle import rle_decode as ref_decode
from bzip3_tpu.ops.ref.rle import rle_encode as ref_encode
from bzip3_tpu_torch.ops.device.rle import rle_decode_batch, rle_encode_batch

RNG = np.random.default_rng(99)
WIDTH = 1536


@pytest.fixture(scope="module")
def rows():
    runs = np.repeat(RNG.integers(0, 6, 200, dtype=np.uint8), RNG.integers(1, 12, 200))
    return [
        b"",
        b"A" * 600 + b"B" * 255 + b"C" * 256 + b"D" * 300,  # cnt255 runs
        bytes(RNG.integers(0, 256, 1400, dtype=np.uint8)),  # random: expands by the bitmap
        bytes(runs[:WIDTH]),  # short runs of a few values
        b"ab" * 20 + b"aa" * 500,
        b"\x00" * 5 + b"xy" * 300 + b"\x00" * 90,
        b"Q",
    ]


def _pad(rows, width):
    arr = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return arr, lens


def test_encode_matches_jax_and_oracle(rows):
    data, lens = _pad(rows, WIDTH)
    out, olens = rle_encode_batch(torch.from_numpy(data), torch.from_numpy(lens))
    jout, jlens = jax_encode(jnp.asarray(data), jnp.asarray(lens))
    np.testing.assert_array_equal(olens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    for i, r in enumerate(rows):
        want = ref_encode(r)
        assert olens[i] == len(want), i
        if len(want) <= out.shape[1]:
            assert out[i, : len(want)].numpy().tobytes() == want, i
    assert int(olens[2]) == len(rows[2]) + 32  # the expanding row keeps its true length


def test_encode_cuts_an_expanding_stream_at_the_width(rows):
    data, lens = _pad(rows, WIDTH)
    w = 512
    out, olens = rle_encode_batch(torch.from_numpy(data), torch.from_numpy(lens), w)
    jout, jlens = jax_encode(jnp.asarray(data), jnp.asarray(lens), out_width=w)
    np.testing.assert_array_equal(olens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert (olens.numpy() > w).any()


def test_decode_matches_jax_and_oracle(rows):
    enc = [ref_encode(r) for r in rows]
    enc[6] = enc[6][:20]  # shorter than the bitmap: not ok
    out_lens = np.array([len(r) for r in rows], np.int32)
    out_lens[5] += 7  # expands to fewer bytes than asked: not ok
    data, in_lens = _pad(enc, max(map(len, enc)))
    got, ok = rle_decode_batch(
        torch.from_numpy(data), torch.from_numpy(in_lens), torch.from_numpy(out_lens), WIDTH
    )
    jgot, jok = jax_decode(jnp.asarray(data), jnp.asarray(in_lens), jnp.asarray(out_lens), WIDTH)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [True] * 5 + [False, False]
    for i, r in enumerate(rows[:5]):
        assert got[i, : len(r)].numpy().tobytes() == r == ref_decode(enc[i], len(r))
        assert not got[i, len(r) :].any()
