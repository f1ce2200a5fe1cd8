"""The port's CRC-32C (``ops/device/crc32.py``, the plain version of the
CUDA kernel K4, and its wrapper ``crc32_cuda``) against the JAX
package: the Pallas lane scan in interpret mode, the XLA ``crc32_batch``,
``crc32_batch_pallas`` and the oracle ``ops/ref/crc32.py``.

Integer and bit exact: tolerance 0.  K4 itself is held against the
plain lane scan on the card by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bzip3_tpu.ops.device import gf2 as jgf2
from bzip3_tpu.ops.device.crc32_pallas import crc32_batch_pallas, crc_lane_scan_pallas
from bzip3_tpu.ops.ref.crc32 import crc32 as ref_crc32
from bzip3_tpu_torch.ops.device import crc32, crc32_cuda, gf2

# the JAX package's ops.device exports a function named crc32 over the module
jcrc = importlib.import_module("bzip3_tpu.ops.device.crc32")

RNG = np.random.default_rng(2024)
LENGTHS = [0, 1, 63, 64, 1000, 4096, 4001]  # 4001: not a multiple of 128
WIDTH = 4160


@pytest.fixture(scope="module")
def batch():
    data = np.zeros((len(LENGTHS), WIDTH), np.uint8)
    for i, n in enumerate(LENGTHS):
        data[i, :n] = RNG.integers(0, 256, n, dtype=np.uint8)
    data[3, :64] = 0xFF  # a row whose states use bit 31 from the start
    return data, np.array(LENGTHS, np.int32)


def test_gf2_tables_match_jax():
    np.testing.assert_array_equal(gf2.CRC_TABLE, jgf2.CRC_TABLE)
    np.testing.assert_array_equal(gf2.Z, jgf2.Z)
    np.testing.assert_array_equal(gf2.Z_INV, jgf2.Z_INV)
    np.testing.assert_array_equal(gf2.shift_matrix(4161), jgf2.shift_matrix(4161))
    np.testing.assert_array_equal(gf2.unshift_pow2_bank(24), jgf2.unshift_pow2_bank(24))
    for lanes, seg in [(1, 5), (128, 37), (300, 3)]:
        np.testing.assert_array_equal(
            crc32._lane_combine_bank(lanes, seg).numpy(),
            jcrc._lane_combine_bank(lanes, seg).astype(np.int64),
        )


def test_lane_scan_matches_pallas(batch):
    """Lane states at 128 lanes, bit for bit, against the Pallas kernel."""
    data = np.ascontiguousarray(batch[0][:, :4096])
    k, lanes = data.shape[0], 128
    seg = data.shape[1] // lanes
    stream = data.reshape(k, 1, lanes, seg).transpose(0, 3, 1, 2)
    want = np.asarray(crc_lane_scan_pallas(jnp.asarray(stream), interpret=True))
    want = want.reshape(k, lanes).view(np.uint32)
    full = torch.full((k,), data.shape[1], dtype=torch.int32)
    got = crc32.crc_lane_scan(torch.from_numpy(data), full, lanes)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    wrapped = crc32_cuda.crc_lane_scan(torch.from_numpy(data), full, lanes)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


def test_crc32_batch_matches_jax_and_oracle(batch):
    data, lens = batch
    want = [ref_crc32(data[i, :n].tobytes()) for i, n in enumerate(LENGTHS)]
    jax_xla = np.asarray(jcrc.crc32_batch(jnp.asarray(data), jnp.asarray(lens)))
    jax_pallas = np.asarray(
        crc32_batch_pallas(jnp.asarray(data), jnp.asarray(lens), lanes=128, interpret=True)
    )
    assert jax_xla.tolist() == want
    assert jax_pallas.tolist() == want
    d, ln = torch.from_numpy(data), torch.from_numpy(lens)
    for lanes in (crc32.LANES, 2048, 128, 7, 1):
        assert crc32.crc32_batch(d, ln, lanes).tolist() == want, lanes
    assert crc32_cuda.crc32_batch(d, ln).tolist() == want
    assert crc32_cuda.LAUNCHES == {"crc_lanes": 0}


def test_bytes_past_length_are_ignored(batch):
    data, lens = batch
    dirty = data.copy()
    for i, n in enumerate(LENGTHS):
        dirty[i, n:] = RNG.integers(0, 256, WIDTH - n, dtype=np.uint8)
    got = crc32.crc32_batch(torch.from_numpy(dirty), torch.from_numpy(lens), 128)
    assert got.tolist() == [ref_crc32(data[i, :n].tobytes()) for i, n in enumerate(LENGTHS)]


@pytest.mark.parametrize(
    "rows, lens, err",
    [
        (torch.zeros((2, 16), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), TypeError),
        (torch.zeros((2, 16), dtype=torch.uint8), torch.zeros(2, dtype=torch.int64), TypeError),
        (torch.zeros((2, 16), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32), ValueError),
        (torch.zeros((16, 2), dtype=torch.uint8).t(), torch.zeros(2, dtype=torch.int32), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(rows, lens, err):
    with pytest.raises(err):
        crc32_cuda.crc_lane_scan(rows, lens, 128)
