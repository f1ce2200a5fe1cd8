"""The port's single-block stage namespace and block codec against the
JAX package, on the CPU.

- ``BlockStages("cpu")`` (the plain versions) and the native engine's
  host namespace (``ops.native.STAGES``) against the oracle
  ``bzip3_tpu.ops.ref``, function by function, on slices of the
  ``tests/fixtures.py`` inputs;
- ``encode_block`` / ``decode_block`` byte-equal to the JAX package's;
- a corruption table, each case raising the same ``Bz3Error`` code on
  both sides (or decoding to the same bytes);
- ``decode_block_recover`` equal to the JAX package's ``(data, ok)``;
- ``Bz3Codec``'s limits.

The tolerance is zero.  The plain CM coder takes ~0.1-0.2 ms a bit step
on a CPU, so every block here is data that RLE and LZP collapse to a few
hundred bytes before the CM stage.
"""

import struct

import numpy as np
import pytest
import torch

from bzip3_tpu.errors import Bz3Error as JaxBz3Error
from bzip3_tpu.models import block_codec as jax_codec
from bzip3_tpu.ops import ref
from bzip3_tpu_torch.container.bound import bound
from bzip3_tpu_torch.errors import (
    BZ3_ERR_DATA_TOO_BIG,
    BZ3_ERR_INIT,
    Bz3Error,
)
from bzip3_tpu_torch.models import block_codec as port_codec
from bzip3_tpu_torch.ops import native
from bzip3_tpu_torch.ops.device.stages import block_stages
from fixtures import sample_mixed, sample_text

BS = 65 * 1024
RNG = np.random.default_rng(21)
TEXT = sample_text()
MIXED = sample_mixed()
# RLE then LZP keep both (model 6): 60,000 bytes to 108 CM bytes
BASE = MIXED[30000:90000]


def _stages(name):
    return block_stages("cpu") if name == "cpu" else native.STAGES


@pytest.fixture(scope="module", params=["cpu", "native"])
def stages(request):
    return _stages(request.param)


# ------------------------------------------------------------ the namespace

STAGE_INPUTS = [b"", b"a", b"ab", TEXT[:700], MIXED[:300], MIXED[30000:36000],
                MIXED[-4000:]]


@pytest.mark.parametrize("i", range(len(STAGE_INPUTS)))
def test_crc_rle_lzp_equal_oracle(stages, i):
    data = STAGE_INPUTS[i]
    assert stages.crc32(data) == ref.crc32(data)
    enc = ref.rle_encode(data)
    assert stages.rle_encode(data) == enc
    assert stages.rle_decode(enc, len(data)) == ref.rle_decode(enc, len(data))
    assert stages.rle_decode(enc[:20], len(data)) == ref.rle_decode(enc[:20], len(data))
    lz = ref.lzp_encode(data)
    assert stages.lzp_encode(data) == lz
    if lz is not None:
        for m in (len(data), bound(len(data)), 10):
            assert stages.lzp_decode(lz, m) == ref.lzp_decode(lz, m)
        assert stages.lzp_decode(lz[:-1], len(data)) == ref.lzp_decode(lz[:-1], len(data))


@pytest.mark.parametrize("data", [b"", b"q", b"qz", TEXT[:257], MIXED[:200]],
                         ids=["0", "1", "2", "text", "random"])
def test_bwt_and_cm_equal_oracle(stages, data):
    u, idx = stages.bwt_forward(data)
    assert (u, idx) == ref.bwt_forward(data)
    n = len(data)
    for index in (idx, 0, -1, n + 1, n):
        assert stages.bwt_inverse(u, index) == ref.bwt_inverse(u, index)
    pay = stages.cm_encode(u)
    assert pay == ref.cm_encode(u)
    assert stages.cm_decode(pay, n) == u
    # an exhausted payload, and garbage, decode as the oracle does
    assert stages.cm_decode(pay[: len(pay) // 2], n + 40) == ref.cm_decode(pay[: len(pay) // 2], n + 40)


@pytest.mark.parametrize("stage_name,n", [(s, n) for s in ("cpu", "native")
                                          for n in (2, 3, 9, 300)] + [("native", 300_000)])
def test_inverse_bwt_of_any_index_equals_oracle(stage_name, n):
    """Recover mode inverts garbage with a damaged index: the walk can
    pass the sentinel inside the row, which the oracle emits as 0xFF
    (the host C++ emitted 0x00 before; ROADMAP.md Queue 3, F2).  n =
    300,000 takes the host's quad-merge walk."""
    stages = _stages(stage_name)
    rng = np.random.default_rng(n)
    u = bytes(rng.integers(0, 4, n, dtype=np.uint8))
    for index in sorted({1, 2, n // 2, n - 1, n} - {0}):
        assert stages.bwt_inverse(u, index) == ref.bwt_inverse(u, index), index


# ------------------------------------------------------------ block codec

BLOCKS = {
    "empty": b"",
    "literal": b"x" * 40,
    "literal63": b"y" * 63,
    "threshold64": b"y" * 64,
    "rle_lzp": BASE,
    "lzp": b"the quick brown fox " * 3200,
    "text": TEXT[:300],
    "random": bytes(RNG.integers(0, 256, 200, dtype=np.uint8)),
}


@pytest.fixture(scope="module")
def encoded():
    return {k: jax_codec.encode_block(v) for k, v in BLOCKS.items()}


@pytest.mark.parametrize("name", BLOCKS)
def test_encode_decode_block_equal_jax(stages, encoded, name):
    data = BLOCKS[name]
    blk = port_codec.encode_block(data, stages)
    assert blk == encoded[name]
    assert port_codec.decode_block(blk, len(data), BS, stages) == data


def _with(block: bytes, off: int, fmt: str, value) -> bytes:
    b = bytearray(block)
    struct.pack_into(fmt, b, off, value)
    return bytes(b)


def _flip(block: bytes, off: int) -> bytes:
    b = bytearray(block)
    b[off] ^= 0x5A
    return bytes(b)


def corruption_cases(blk: bytes, n: int):
    """(name, block, orig_size, block_size, buffer_size) of a model-6
    block: header fields, payload, truncation, sizes and buffer."""
    hdr = jax_codec.parse_block_header(blk)
    assert hdr.model == 6
    cap = bound(BS)
    lit = struct.pack("<Ii", ref.crc32(b"abc"), -1) + b"abc"
    return [
        ("sound", blk, n, BS, None),
        ("crc", _flip(blk, 0), n, BS, None),
        ("bwt_idx_past_size", _with(blk, 4, "<i", hdr.lzp_size + 1), n, BS, None),
        ("bwt_idx_zero", _with(blk, 4, "<i", 0), n, BS, None),
        ("bwt_idx_other", _with(blk, 4, "<i", hdr.bwt_idx // 2 + 1), n, BS, None),
        ("bwt_idx_literal", _with(blk, 4, "<i", -1), n, BS, None),
        ("bwt_idx_negative", _with(blk, 4, "<i", -7), n, BS, None),
        ("model_lzp_only", _with(blk, 8, "<B", 2), n, BS, None),
        ("model_rle_only", _with(blk, 8, "<B", 4), n, BS, None),
        ("lzp_size_negative", _with(blk, 9, "<i", -3), n, BS, None),
        ("lzp_size_past_bound", _with(blk, 9, "<i", cap + 1), n, BS, None),
        ("lzp_size_smaller", _with(blk, 9, "<i", hdr.lzp_size - 9), n, BS, None),
        ("rle_size_past_bound", _with(blk, 13, "<i", cap + 1), n, BS, None),
        ("rle_size_other", _with(blk, 13, "<i", hdr.rle_size + 5), n, BS, None),
        ("payload_byte", _flip(blk, len(blk) // 2 + 8), n, BS, None),
        ("payload_last", _flip(blk, len(blk) - 1), n, BS, None),
        ("truncated_payload", blk[:-10], n, BS, None),
        ("truncated_7", blk[:7], n, BS, None),
        ("truncated_8", blk[:8], n, BS, None),
        ("truncated_12", blk[:12], n, BS, None),
        ("truncated_16", blk[:16], n, BS, None),
        ("past_bound", blk + b"\x00" * cap, n, BS, None),
        ("orig_size_plus", blk, n + 1, BS, None),
        ("orig_size_minus", blk, n - 1, BS, None),
        ("orig_size_negative", blk, -1, BS, None),
        ("orig_size_past_bound", blk, cap + 1, BS, None),
        ("block_size_small", blk, n, 1024, None),
        ("buffer_8", blk, n, BS, 8),
        ("buffer_under_block", blk, n, BS, len(blk) - 1),
        ("buffer_under_orig", blk, n, BS, n - 1),
        ("buffer_under_rle", blk, n, BS, hdr.rle_size - 1),
        ("literal_sound", lit, 3, BS, None),
        ("literal_crc", _flip(lit, 1), 3, BS, None),
        ("literal_long", lit + b"z" * 62, 65, BS, None),
    ]


CASES = [c[0] for c in corruption_cases(jax_codec.encode_block(BASE), len(BASE))]


def _outcome(fn):
    try:
        return ("ok", fn())
    except (Bz3Error, JaxBz3Error) as e:
        return ("error", e.code)


@pytest.mark.parametrize("case", CASES)
def test_corruption_same_error_code(stages, encoded, case):
    blk = encoded["rle_lzp"]
    _, block, n, bs, buf = next(c for c in corruption_cases(blk, len(BASE)) if c[0] == case)
    want = _outcome(lambda: jax_codec.decode_block(block, n, bs, buffer_size=buf))
    got = _outcome(lambda: port_codec.decode_block(block, n, bs, stages, buf))
    assert got == want


def recover_case(blk: bytes, case: str) -> bytes:
    hdr = jax_codec.parse_block_header(blk)
    if case == "payload_byte":
        return _flip(blk, len(blk) // 2 + 8)
    if case == "crc":
        return _flip(blk, 2)
    if case == "bwt_idx":
        return _with(blk, 4, "<i", hdr.bwt_idx // 2 + 1)
    if case == "lzp_size":
        return _with(blk, 9, "<i", hdr.lzp_size + 37)
    if case == "lzp_size_bound":  # the decoded length clamps to bound(BS)
        return _with(blk, 9, "<i", bound(BS))
    if case == "truncated":
        return blk[:-12]
    return blk


# The plain CM decodes bound(65 KiB) steps in minutes on a CPU, so the
# damaged size at the bound runs through the host codec here, and
# through K3b on the card in chip_smoke.py.
RECOVER = [(s, c) for s in ("cpu", "native")
           for c in ("payload_byte", "crc", "bwt_idx", "lzp_size", "lzp_size_bound",
                     "truncated", "sound")
           if (s, c) != ("cpu", "lzp_size_bound")]


@pytest.mark.parametrize("stage_name,case", RECOVER)
def test_decode_block_recover_equals_jax(encoded, stage_name, case):
    blk = recover_case(encoded["rle_lzp"], case)
    want = jax_codec.decode_block_recover(blk, len(BASE), BS)
    got = port_codec.decode_block_recover(blk, len(BASE), BS, _stages(stage_name))
    assert got == want
    assert got[1] == (case == "sound")
    assert len(got[0]) == len(BASE)


def test_codec_limits():
    with pytest.raises(Bz3Error) as e:
        port_codec.Bz3Codec(1000, device="cpu")
    assert e.value.code == BZ3_ERR_INIT
    with pytest.raises(Bz3Error) as e:
        port_codec.Bz3Codec(512 << 20, device="cpu")
    assert e.value.code == BZ3_ERR_INIT
    codec = port_codec.Bz3Codec(BS, device="cpu")
    with pytest.raises(Bz3Error) as e:
        codec.encode_block(b"\x00" * (BS + 1))
    assert e.value.code == BZ3_ERR_DATA_TOO_BIG
    jax = jax_codec.Bz3Codec(BS)
    blk = codec.encode_block(BASE)
    assert blk == jax.encode_block(BASE)
    assert codec.decode_block(blk, len(BASE)) == BASE
    for buf in (None, len(blk), 20):
        assert _outcome(lambda: codec.decode_block(blk, len(BASE), buf)) == \
            _outcome(lambda: jax.decode_block(blk, len(BASE), buf))


def test_default_stages_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_codec.Bz3Codec(BS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_codec.encode_block(b"abc")
