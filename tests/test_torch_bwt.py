"""Batched BWT in PyTorch (the port's ``ops/device/bwt.py``) against the
JAX package's ``ops/device/bwt.py`` and the oracle ``ops/ref/bwt.py``.

Byte-exact (tolerance 0) on groups of rows, each one batch of the port: a mixed
variable-length group (an all-zero row, a periodic row, rows of length
0, 1 and 2, text and random rows); rows of period 1, 2 and 3, which need
the most doubling rounds at their width; lengths 0, 1, 2, 63 and 64 in
one group as wide as its longest row; and a group whose rows' lengths
differ by two orders of magnitude.  The JAX package runs once, on
every group's rows in one batch (``_jax_results``): each row's result is
its own, whatever the batch.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bzip3_tpu.ops.device import bwt as jbwt
from bzip3_tpu.ops.ref.bwt import bwt_forward, bwt_inverse
from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch, bwt_inverse_batch

RNG = np.random.default_rng(2024)
_TEXT = b"the quick brown fox jumps over the lazy dog. " * 20

GROUPS = {
    "mixed": [
        b"\x00" * 1000,
        (b"qwertyui" * 200)[:1203],  # periodic: deep doubling
        b"",
        b"z",
        b"ba",
        _TEXT,
        bytes(RNG.integers(0, 256, 1280, dtype=np.uint8)),
        bytes(RNG.integers(0, 3, 777, dtype=np.uint8)),
        bytes(RNG.integers(97, 100, 64, dtype=np.uint8)),
    ],
    # period 1, 2 and 3 runs: every doubling round up to the width
    "periodic": [b"a" * 1536, b"ab" * 768, b"abc" * 512],
    "short": [b"", b"q", b"qz", bytes(RNG.integers(0, 256, 63, dtype=np.uint8)),
              bytes(RNG.integers(0, 4, 64, dtype=np.uint8))],
    "widths": [b"ok", _TEXT[:300], bytes(RNG.integers(0, 2, 900, dtype=np.uint8)),
               (b"xy" * 1024)[:2047]],
}


@pytest.fixture(scope="module", params=list(GROUPS))
def rows(request):
    return GROUPS[request.param]


def _width(rows) -> int:
    """A group's batch width: its longest row (the short group's 64-byte
    row fills it)."""
    return max(map(len, rows))


def _pad(rows, width):
    arr = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros((len(rows),), np.int32)
    for i, b in enumerate(rows):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return arr, lens


@pytest.fixture(scope="module")
def forward(rows):
    data, lens = _pad(rows, _width(rows))
    u, idx = bwt_forward_batch(torch.from_numpy(data), torch.from_numpy(lens))
    return u.numpy(), idx.numpy()


def test_forward_matches_oracle(rows, forward):
    u, idx = forward
    for i, r in enumerate(rows):
        want_u, want_idx = bwt_forward(r)
        assert u[i, : len(r)].tobytes() == want_u, f"row {i}"
        assert int(idx[i]) == want_idx, f"row {i}"
        assert not u[i, len(r) :].any()


@functools.cache
def _jax_results() -> dict:
    """The JAX package's forward BWT of every group's rows, and its
    inverse of the port's forward of them, each in one batch as wide as
    the longest row: {group: (U, index, inverse)}, rows in group order."""
    names = list(GROUPS)
    rows = [r for g in names for r in GROUPS[g]]
    data, lens = _pad(rows, max(map(len, rows)))
    ju, jidx = map(np.asarray, jbwt.bwt_forward_batch(jnp.asarray(data), jnp.asarray(lens)))
    u, idx, at = np.zeros_like(data), np.zeros_like(lens), 0
    for g in names:
        gdata, glens = _pad(GROUPS[g], _width(GROUPS[g]))
        gu, gidx = bwt_forward_batch(torch.from_numpy(gdata), torch.from_numpy(glens))
        u[at : at + len(gu), : gu.shape[1]] = gu.numpy()
        idx[at : at + len(gu)] = gidx.numpy()
        at += len(gu)
    jinv = np.asarray(jbwt.bwt_inverse_batch(jnp.asarray(u), jnp.asarray(lens), jnp.asarray(idx)))
    out, at = {}, 0
    for g in names:
        k = len(GROUPS[g])
        out[g] = ju[at : at + k], jidx[at : at + k], jinv[at : at + k]
        at += k
    return out


def _jax(rows) -> tuple:
    return _jax_results()[next(g for g, v in GROUPS.items() if v is rows)]


def test_forward_matches_jax(rows, forward):
    ju, jidx, _ = _jax(rows)
    u, idx = forward
    np.testing.assert_array_equal(idx, jidx)
    for i, r in enumerate(rows):
        assert u[i, : len(r)].tobytes() == ju[i, : len(r)].tobytes(), f"row {i}"


def test_inverse_matches_oracle_and_jax(rows, forward):
    u, idx = forward
    _, lens = _pad(rows, _width(rows))
    got = bwt_inverse_batch(
        torch.from_numpy(u), torch.from_numpy(lens), torch.from_numpy(idx)
    ).numpy()
    jgot = _jax(rows)[2]  # the JAX inverse of the port's U, in the shared batch
    for i, r in enumerate(rows):
        assert got[i, : len(r)].tobytes() == r, f"row {i}"
        assert got[i, : len(r)].tobytes() == jgot[i, : len(r)].tobytes(), f"row {i}"
        assert bwt_inverse(u[i, : len(r)].tobytes(), int(idx[i])) == r


def test_inverse_ignores_bytes_past_each_row(rows, forward):
    """The CM decode kernel leaves bytes past a row's length unwritten;
    the inverse must not read them."""
    u, idx = forward
    width = _width(rows)
    _, lens = _pad(rows, width)
    junk = u.copy()
    for i, r in enumerate(rows):
        junk[i, len(r) :] = RNG.integers(0, 256, width - len(r), dtype=np.uint8)
    got = bwt_inverse_batch(
        torch.from_numpy(junk), torch.from_numpy(lens), torch.from_numpy(idx)
    ).numpy()
    for i, r in enumerate(rows):
        assert got[i, : len(r)].tobytes() == r, f"row {i}"
