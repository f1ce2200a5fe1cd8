"""Batched BWT in PyTorch (the port's ``ops/device/bwt.py``) against the
JAX package's ``ops/device/bwt.py`` and the oracle ``ops/ref/bwt.py``.

Byte-exact (tolerance 0) on one variable-length batch that holds an
all-zero row, a periodic row, rows of length 0, 1 and 2, text and
random rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bzip3_tpu.ops.device import bwt as jbwt
from bzip3_tpu.ops.ref.bwt import bwt_forward, bwt_inverse
from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch, bwt_inverse_batch

RNG = np.random.default_rng(2024)
WIDTH = 1280


@pytest.fixture(scope="module")
def rows():
    return [
        b"\x00" * 1000,
        (b"qwertyui" * 200)[:1203],  # periodic: deep doubling
        b"",
        b"z",
        b"ba",
        b"the quick brown fox jumps over the lazy dog. " * 20,
        bytes(RNG.integers(0, 256, WIDTH, dtype=np.uint8)),
        bytes(RNG.integers(0, 3, 777, dtype=np.uint8)),
        bytes(RNG.integers(97, 100, 64, dtype=np.uint8)),
    ]


def _pad(rows, width):
    arr = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros((len(rows),), np.int32)
    for i, b in enumerate(rows):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return arr, lens


@pytest.fixture(scope="module")
def forward(rows):
    data, lens = _pad(rows, WIDTH)
    u, idx = bwt_forward_batch(torch.from_numpy(data), torch.from_numpy(lens))
    return u.numpy(), idx.numpy()


def test_forward_matches_oracle(rows, forward):
    u, idx = forward
    for i, r in enumerate(rows):
        want_u, want_idx = bwt_forward(r)
        assert u[i, : len(r)].tobytes() == want_u, f"row {i}"
        assert int(idx[i]) == want_idx, f"row {i}"
        assert not u[i, len(r) :].any()


def test_forward_matches_jax(rows, forward):
    data, lens = _pad(rows, WIDTH)
    ju, jidx = jbwt.bwt_forward_batch(jnp.asarray(data), jnp.asarray(lens))
    ju, jidx = np.asarray(ju), np.asarray(jidx)
    u, idx = forward
    np.testing.assert_array_equal(idx, jidx)
    for i, r in enumerate(rows):
        assert u[i, : len(r)].tobytes() == ju[i, : len(r)].tobytes(), f"row {i}"


def test_inverse_matches_oracle_and_jax(rows, forward):
    u, idx = forward
    _, lens = _pad(rows, WIDTH)
    got = bwt_inverse_batch(
        torch.from_numpy(u), torch.from_numpy(lens), torch.from_numpy(idx)
    ).numpy()
    jgot = np.asarray(
        jbwt.bwt_inverse_batch(jnp.asarray(u), jnp.asarray(lens), jnp.asarray(idx))
    )
    for i, r in enumerate(rows):
        assert got[i, : len(r)].tobytes() == r, f"row {i}"
        assert got[i, : len(r)].tobytes() == jgot[i, : len(r)].tobytes(), f"row {i}"
        assert bwt_inverse(u[i, : len(r)].tobytes(), int(idx[i])) == r


def test_inverse_ignores_bytes_past_each_row(rows, forward):
    """The CM decode kernel leaves bytes past a row's length unwritten;
    the inverse must not read them."""
    u, idx = forward
    _, lens = _pad(rows, WIDTH)
    junk = u.copy()
    for i, r in enumerate(rows):
        junk[i, len(r) :] = RNG.integers(0, 256, WIDTH - len(r), dtype=np.uint8)
    got = bwt_inverse_batch(
        torch.from_numpy(junk), torch.from_numpy(lens), torch.from_numpy(idx)
    ).numpy()
    for i, r in enumerate(rows):
        assert got[i, : len(r)].tobytes() == r, f"row {i}"
