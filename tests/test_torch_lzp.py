"""The port's LZP (``ops/device/lzp.py``, the plain version of the CUDA
kernels K5/K6, and their wrappers ``lzp_cuda``) against the JAX
package's Pallas kernels in interpret mode and the oracle
``ops/ref/lzp.py``.

Byte exact: tolerance 0.  The cases are those of ``test_lzp_pallas.py``:
the encoder's ``heur`` rejection, word + 0..3 match extension, base-254
lengths, 0xF2 escapes with and without a live prediction, and the
out_cap guard.  K5/K6 themselves are held against the plain version on
the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bzip3_tpu.ops.device.lzp_pallas import lzp_decode_pallas_batch, lzp_encode_pallas_batch
from bzip3_tpu.ops.ref.lzp import MATCH
from bzip3_tpu.ops.ref.lzp import lzp_decode as ref_decode
from bzip3_tpu.ops.ref.lzp import lzp_encode as ref_encode
from bzip3_tpu_torch.ops.device import lzp, lzp_cuda

RNG = np.random.default_rng(42)


def _cases():
    text = (b"the quick brown fox jumps over the lazy dog. " * 40)[:1600]
    long_match = text[:200] + b"X" * 30 + text[:200] + b"Y" * 30 + text[:500]
    big_run = b"A" * 700 + b"B" * 11 + b"A" * 700
    esc = bytes([MATCH]) * 90 + text[:300] + bytes([MATCH, MATCH, 1, 2, MATCH])
    rnd = bytes(RNG.integers(0, 256, 1500, dtype=np.uint8))
    periodic = b"abcdefgh" * 200
    heur = b"".join(b"CTXT" + bytes([i]) * 9 for i in range(40))
    vlong = (text * 20)[:12000]  # multi-254 length bytes
    return [
        text, long_match, big_run, esc, rnd, periodic, heur, b"tiny", vlong,
        b"", b"Z" * 71, b"Z" * 72,
    ]


@pytest.fixture(scope="module")
def cases():
    return _cases()


def _pad(rows, width):
    arr = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return arr, lens


@pytest.fixture(scope="module")
def encoded(cases):
    data, lens = _pad(cases, max(map(len, cases)))
    return lzp.lzp_encode_batch(torch.from_numpy(data), torch.from_numpy(lens))


def test_encode_matches_pallas_and_oracle(cases, encoded):
    out, olens = encoded
    data, lens = _pad(cases, max(map(len, cases)))
    jout, jlens = lzp_encode_pallas_batch(jnp.asarray(data), jnp.asarray(lens), interpret=True)
    jout, jlens = np.asarray(jout), np.asarray(jlens)
    np.testing.assert_array_equal(olens.numpy(), jlens)
    assert out.shape == (len(cases), data.shape[1] + lzp.OUT_PAD)
    for i, c in enumerate(cases):
        want = ref_encode(c)
        if want is None:
            assert olens[i] == -1, i
            assert not out[i].any(), i
        else:
            assert out[i, : olens[i]].numpy().tobytes() == want == jout[i, : jlens[i]].tobytes()
    assert (olens >= 0).sum() >= 6 and MATCH in out[8].tolist()


def test_decode_round_trip_matches_pallas(cases, encoded):
    out, olens = encoded
    keep = [i for i in range(len(cases)) if olens[i] >= 0]
    streams = [out[i, : olens[i]].numpy().tobytes() for i in keep]
    data, lens = _pad(streams, max(map(len, streams)))
    max_out = max(len(cases[i]) for i in keep) + 64
    got, glens = lzp.lzp_decode_batch(torch.from_numpy(data), torch.from_numpy(lens), max_out)
    jgot, jlens = lzp_decode_pallas_batch(
        jnp.asarray(data), jnp.asarray(lens), max_out, interpret=True
    )
    np.testing.assert_array_equal(glens.numpy(), np.asarray(jlens))
    for j, i in enumerate(keep):
        assert got[j, : glens[j]].numpy().tobytes() == cases[i] == ref_decode(streams[j], max_out)
        assert np.asarray(jgot)[j, : jlens[j]].tobytes() == cases[i]


def test_decode_truncated_token_and_max_out_cut():
    """A stream cut right after a match token, and one whose match runs
    past max_out (cut there), like the oracle; streams under 4 bytes and
    rows of length 0 report -1."""
    base = (b"the quick brown fox jumps over the lazy dog. " * 40)[:1600]
    e = ref_encode(base + base[:300])
    cut = e[: e.index(bytes([MATCH])) + 1]
    assert ref_decode(cut, 4096) is None
    rows = [cut, e, e, b"abc", b""]
    data, lens = _pad(rows, len(e))
    max_out = 1000
    got, glens = lzp.lzp_decode_batch(torch.from_numpy(data), torch.from_numpy(lens), max_out)
    jgot, jlens = lzp_decode_pallas_batch(
        jnp.asarray(data[:3]), jnp.asarray(lens[:3]), max_out, interpret=True
    )
    assert glens.tolist() == [-1, max_out, max_out, -1, -1]
    np.testing.assert_array_equal(glens[:3].numpy(), np.asarray(jlens))
    want = ref_decode(e, max_out)
    assert len(want) == max_out
    assert got[1].numpy().tobytes() == want == np.asarray(jgot)[1, :max_out].tobytes()


def test_wrappers_take_plain_path_for_cpu_tensors(cases, encoded):
    data, lens = _pad(cases[:3], 1600)
    out, olens = lzp_cuda.lzp_encode(torch.from_numpy(data), torch.from_numpy(lens))
    want_out, want_lens = encoded
    assert olens.tolist() == want_lens[:3].tolist()
    back, blens = lzp_cuda.lzp_decode(out, olens, 1600)
    for i in range(3):
        assert out[i, : olens[i]].equal(want_out[i, : olens[i]])
        assert back[i, : blens[i]].numpy().tobytes() == cases[i]
    assert lzp_cuda.LAUNCHES == {"lzp_encode": 0, "lzp_decode": 0}
    with pytest.raises(ValueError):
        lzp_cuda.lzp_decode(out, olens, 3)
    with pytest.raises(TypeError):
        lzp_cuda.lzp_encode(torch.from_numpy(data).int(), torch.from_numpy(lens))
