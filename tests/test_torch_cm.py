"""Plain PyTorch CM coder (the port's ``ops/device/cm.py``, the plain
version of the CUDA kernels K1/K2) against the JAX package's plain CM
(``ops/device/cm.py``) and the oracle (``ops/ref/cm.py``).

Byte-exact: the codec is lossless, so the tolerance is 0.  The CUDA
kernels themselves are held against this plain version on the card by
``chip_smoke.py``; on CPU tensors the wrappers in ``cm_cuda`` take the
plain path, which the last tests pin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bzip3_tpu.ops.device import cm as jcm
from bzip3_tpu.ops.ref.cm import cm_decode, cm_encode
from bzip3_tpu_torch.ops.device import cm, cm_cuda

RNG = np.random.default_rng(1234)


@pytest.fixture(scope="module")
def blocks():
    # the 8-row fixture of test_cm_pallas.py
    return [
        bytes(RNG.integers(97, 123, 300, dtype=np.uint8)),
        bytes(RNG.integers(0, 256, 513, dtype=np.uint8)),
        b"abcabcabc" * 40,  # run flag exercises the SSE odd contexts
        b"\x00" * 200,
        bytes(RNG.integers(0, 4, 700, dtype=np.uint8)),
        b"",
        b"Q",
        b"\xff" * 130,
    ]


@pytest.fixture(scope="module")
def encoded(blocks):
    return [cm_encode(b) for b in blocks]


def _pad(rows, width):
    arr = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros((len(rows),), np.int32)
    for i, b in enumerate(rows):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return arr, lens


def test_fresh_tables_match_jax():
    for got, want in zip(cm.cm_fresh_tables(3), jcm.cm_fresh_tables(3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))


def test_encode_matches_jax_and_oracle(blocks, encoded):
    data, lens = _pad(blocks, 704)
    out, olens = cm.cm_encode_batch(torch.from_numpy(data), torch.from_numpy(lens))
    jout, jlens = jcm.cm_encode_batch(jnp.asarray(data), jnp.asarray(lens))
    jout, jlens = np.asarray(jout), np.asarray(jlens)
    assert out.shape == jout.shape
    np.testing.assert_array_equal(olens.numpy(), jlens)
    for i, want in enumerate(encoded):
        got = out[i, : olens[i]].numpy().tobytes()
        assert got == want, f"row {i}"
        assert got == jout[i, : jlens[i]].tobytes(), f"row {i}"


def test_decode_matches_jax_and_oracle(blocks, encoded):
    pdata, plens = _pad(encoded, 768)
    _, lens = _pad(blocks, 704)
    args = (pdata, plens, lens)
    got = cm.cm_decode_batch(*map(torch.from_numpy, args), 704).numpy()
    jgot = np.asarray(jcm.cm_decode_batch(*map(jnp.asarray, args), 704))
    np.testing.assert_array_equal(got, jgot)
    for i, b in enumerate(blocks):
        assert got[i, : lens[i]].tobytes() == b, f"row {i}"
        assert not got[i, lens[i] :].any()


def test_decode_truncated_payload_exhaustion_rule(blocks, encoded):
    """A payload cut short shifts in (code << 8) - 1 past its end; the
    decoded bytes then follow the oracle's read_in(-1) exactly."""
    cut = [e[: len(e) // 2] for e in encoded]
    pdata, plens = _pad(cut, 768)  # the shape of the test above: one JAX compile
    _, lens = _pad(blocks, 704)
    got = cm.cm_decode_batch(
        torch.from_numpy(pdata), torch.from_numpy(plens), torch.from_numpy(lens), 704
    ).numpy()
    jgot = np.asarray(
        jcm.cm_decode_batch(jnp.asarray(pdata), jnp.asarray(plens), jnp.asarray(lens), 704)
    )
    np.testing.assert_array_equal(got, jgot)
    for i, b in enumerate(blocks):
        assert got[i, : len(b)].tobytes() == cm_decode(cut[i], len(b)), f"row {i}"


def test_encode_capped_overflow_reports_true_length(blocks):
    """A row whose payload exceeds the output width reports its true
    length with its writes past the width dropped; rows that fit stay
    byte-exact (as test_cm_pallas_encode_capped_overflow)."""
    rng = np.random.default_rng(5)
    incompressible = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    cases = [blocks[0], incompressible, blocks[2]]
    data, lens = _pad(cases, 1024)
    cap = 512
    out, olens = cm.cm_encode_batch(torch.from_numpy(data), torch.from_numpy(lens), cap)
    assert out.shape == (3, cap)
    assert int(olens[1]) == len(cm_encode(incompressible)) > cap
    for i in (0, 2):
        assert out[i, : olens[i]].numpy().tobytes() == cm_encode(cases[i]), f"row {i}"


def _renorm_loop(low: int, high: int):
    """The reference's renorm: shift while the top byte of low ^ high is 0."""
    k = 0
    while (low ^ high) < (1 << 24):
        low, high = (low << 8) & cm.M32, ((high << 8) & cm.M32) | 0xFF
        k += 1
    return k, low, high


@pytest.mark.parametrize("xor", [0, 0xFF, 0xFFFF, 0xFFFFFF, 0x1000000, 0xFFFFFFFF, None])
def test_renorm_count_closed_form(xor):
    """The closed-form renorm count (and the one shift by it) that the
    kernels and the plain coders use equals the reference's loop: on the
    edge states low ^ high = xor, and (None) on 10,000 seeded random
    pairs whose low ^ high has 0-4 leading zero bytes."""
    rng = np.random.default_rng(7)
    low = rng.integers(0, 1 << 32, 10_000, dtype=np.int64)
    if xor is None:
        x = rng.integers(0, 1 << 32, low.shape, dtype=np.int64) >> (8 * rng.integers(0, 5, low.shape))
    else:
        x = np.full_like(low, xor)
    high = low ^ x
    want = np.array([_renorm_loop(int(a), int(b)) for a, b in zip(low, high)])
    lo, hi = torch.from_numpy(low), torch.from_numpy(high)
    k = cm.renorm_count(lo, hi)
    np.testing.assert_array_equal(k.numpy(), want[:, 0])
    lo2, hi2 = cm._renorm(lo, hi, k)
    np.testing.assert_array_equal(lo2.numpy(), want[:, 1])
    np.testing.assert_array_equal(hi2.numpy(), want[:, 2])
    if xor is None:
        assert set(want[:, 0]) == {0, 1, 2, 3, 4}


def test_wrappers_take_plain_path_for_cpu_tensors(blocks, encoded):
    rows = [2, 3, 6]
    data, lens = _pad([blocks[i] for i in rows], 368)
    out, olens = cm_cuda.cm_encode(torch.from_numpy(data), torch.from_numpy(lens))
    pdata, plens = _pad([encoded[i] for i in rows], 64)
    dec = cm_cuda.cm_decode(
        torch.from_numpy(pdata), torch.from_numpy(plens), torch.from_numpy(lens), 368
    )
    for j, i in enumerate(rows):
        assert out[j, : olens[j]].numpy().tobytes() == encoded[i]
        assert dec[j, : lens[j]].numpy().tobytes() == blocks[i]
    assert not any(cm_cuda.LAUNCHES.values())


@pytest.mark.parametrize(
    "data, lens, err",
    [
        (torch.zeros((2, 16), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), TypeError),
        (torch.zeros((2, 16), dtype=torch.uint8), torch.zeros(2, dtype=torch.int64), TypeError),
        (torch.zeros((2, 16), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32), ValueError),
        (torch.zeros((16, 2), dtype=torch.uint8).t(), torch.zeros(2, dtype=torch.int32), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(data, lens, err):
    with pytest.raises(err):
        cm_cuda.cm_encode(data, lens)
