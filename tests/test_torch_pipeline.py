"""The port's block pipeline end to end on the CPU, against the JAX
package's ``DevicePipeline`` on the blocks of ``test_pipeline.py``.

Both produce BZ3v1 block bytes; they must be identical, and each must
decode the other's, on the default path and on the device prepass chain
(``BZ3_TPU_DEVICE_PREPASS=1`` in the JAX package).  The JAX package runs
once, through its full chain (``jax_full``): its blocks equal its default
path's (``tests/test_pipeline.py`` pins both to the oracle codec), so its
encode and its decode of the port's blocks serve every comparison.  The
port's entry points run on the card by default, so without one they must
raise rather than use the CPU.  The oversize route (host BWT, resumable
CM) is forced at a tiny cap, as ``tests/test_pipeline.py`` forces the
JAX package's.
"""

import io

import numpy as np
import pytest
import torch

from bzip3_tpu.models.block_codec import encode_block
from bzip3_tpu.pipeline import DevicePipeline as JaxPipeline
from bzip3_tpu_torch import compress, compress_file, decompress, decompress_file
from bzip3_tpu_torch.engines import DeviceEngine
from bzip3_tpu_torch.errors import BZ3_ERR_CRC, Bz3Error
from bzip3_tpu_torch.pipeline import DevicePipeline
from bzip3_tpu_torch.models.block_codec import parse_block_header

BS = 1024
RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def blocks(text_data):
    return [
        text_data[:BS],
        bytes(RNG.integers(0, 256, BS, dtype=np.uint8)),
        b"ab" * (BS // 2),
        b"x" * 40,  # literal path (< 64 bytes)
        text_data[BS : 2 * BS],
        b"\x00" * BS,
        bytes(RNG.integers(0, 16, 700, dtype=np.uint8)),
        b"",
    ]


@pytest.fixture(scope="module")
def engine():
    return DeviceEngine(device="cpu")


@pytest.fixture(scope="module")
def port_blocks(engine, blocks):
    return engine.encode_blocks(blocks, BS)


@pytest.fixture(scope="module")
def jax_full(blocks, port_blocks):
    """The JAX full-device chain once: its encode of the blocks, and its
    decode of the port's blocks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BZ3_TPU_DEVICE_PREPASS", "1")
        pipe = JaxPipeline(BS)
        assert pipe._full_cores()
        enc = pipe.encode_blocks(blocks)
        dec = pipe.decode_blocks([(e, len(b)) for e, b in zip(port_blocks, blocks)])
    return enc, dec


@pytest.fixture(scope="module")
def jax_blocks(jax_full):
    return jax_full[0]


def test_port_encodes_like_jax(port_blocks, jax_blocks, engine):
    assert port_blocks == jax_blocks
    assert engine.reencoded_rows == 0


def test_port_decodes_jax_blocks(engine, jax_blocks, blocks):
    pairs = [(e, len(b)) for e, b in zip(jax_blocks, blocks)]
    assert engine.decode_blocks(pairs, BS) == blocks


def test_jax_decodes_port_blocks(jax_full, blocks):
    assert jax_full[1] == blocks


def test_corrupted_crc_raises(engine, port_blocks, blocks):
    for i in (2, 3):  # a coded block and a literal block
        bad = bytearray(port_blocks[i])
        bad[0] ^= 0x01  # the stored CRC32
        with pytest.raises(Bz3Error):
            engine.decode_blocks([(bytes(bad), len(blocks[i]))], BS)


def test_overflow_row_is_reencoded_exactly(blocks, port_blocks, monkeypatch):
    """A CM payload past its buffer is encoded again at its true length,
    counted in ``reencoded_rows``, and the block bytes do not change."""
    from bzip3_tpu_torch.ops.device import cm_cuda

    real = cm_cuda.cm_encode

    def capped(data, lengths, out_width=None):
        return real(data, lengths, 64 if out_width is None else out_width)

    monkeypatch.setattr(cm_cuda, "cm_encode", capped)
    eng = DeviceEngine(device="cpu")
    assert eng.encode_blocks(blocks[:1], BS) == port_blocks[:1]
    assert eng.reencoded_rows == 1


def test_frame_and_stream_round_trip(text_data):
    # two blocks at the smallest block size; LZP shrinks them to some
    # two hundred bytes each, which keeps the plain CM quick
    data = (text_data[:120] * 600)[:70000]
    bs = 65 * 1024
    frame = compress(data, bs, device="cpu")
    assert int.from_bytes(frame[9:13], "little") == 2
    assert decompress(frame, device="cpu") == data

    buf = io.BytesIO()
    compress_file(io.BytesIO(data), buf, bs, batch_size=2, device="cpu")
    out = io.BytesIO()
    decompress_file(io.BytesIO(buf.getvalue()), out, batch_size=2, device="cpu")
    assert out.getvalue() == data


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        compress(b"x" * 100)
    with pytest.raises(RuntimeError, match="CUDA"):
        decompress_file(io.BytesIO(b"BZ3v1\x00\x00\x01\x00"), io.BytesIO())


@pytest.fixture(scope="module")
def prepass_engine():
    return DeviceEngine(device="cpu", device_prepass=True)


@pytest.fixture(scope="module")
def prepass_blocks(prepass_engine, blocks):
    return prepass_engine.encode_blocks(blocks, BS)


def test_device_prepass_matches_jax_full_chain(
    prepass_engine, prepass_blocks, port_blocks, jax_full, blocks
):
    jax_enc, jax_dec = jax_full
    assert prepass_blocks == jax_enc == port_blocks
    models = {parse_block_header(b).model for b in prepass_blocks}
    assert {2, 4} <= {m & 6 for m in models}  # LZP and RLE each kept somewhere
    assert jax_dec == blocks  # the JAX chain's decode of these same blocks
    assert prepass_engine.decode_blocks([(e, len(b)) for e, b in zip(jax_enc, blocks)], BS) == blocks
    assert prepass_engine.reencoded_rows == 0


def test_device_crc_switches_keep_the_default_bytes(port_blocks, blocks):
    eng = DeviceEngine(device="cpu", host_crc=False, device_crc_verify=True)
    assert eng.encode_blocks(blocks, BS) == port_blocks
    pairs = [(e, len(b)) for e, b in zip(port_blocks, blocks)]
    assert eng.decode_blocks(pairs, BS) == blocks
    for i in (2, 3):  # a coded block and a literal block
        bad = bytearray(port_blocks[i])
        bad[0] ^= 0x01
        with pytest.raises(Bz3Error):
            eng.decode_blocks([(bytes(bad), len(blocks[i]))], BS)


def test_device_prepass_corrupted_lzp_payload_raises(prepass_engine, prepass_blocks, blocks):
    i = next(j for j, b in enumerate(prepass_blocks) if parse_block_header(b).model & 2)
    hdr = parse_block_header(prepass_blocks[i])
    bad = bytearray(prepass_blocks[i])
    for k in range(hdr.header_size() + 4, len(bad), 7):
        bad[k] ^= 0x5A
    with pytest.raises(Bz3Error) as err:
        prepass_engine.decode_blocks([(bytes(bad), len(blocks[i]))], BS)
    assert err.value.code == BZ3_ERR_CRC


@pytest.fixture(scope="module")
def oversize(text_data):
    """The forced oversize route at 1 KiB blocks (tests/test_pipeline.py's
    cases), its blocks and their decode."""
    rng = np.random.default_rng(11)
    cases = [
        text_data[:BS],
        b"ab" * (BS // 2),
        b"x" * 40,  # literal path
        bytes(rng.integers(0, 256, BS, dtype=np.uint8)),
        text_data[BS : BS + 700],
    ]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BZ3_TPU_MAX_DEVICE_BLOCK_MIB", "0.0005")
        mp.setenv("BZ3_TPU_FORCE_OVERSIZE", "1")
        pipe = DevicePipeline(BS, device="cpu")
        enc = pipe.encode_blocks(cases)
        dec = pipe.decode_blocks([(e, len(b)) for e, b in zip(enc, cases)])
    return pipe, cases, enc, dec


def test_oversize_route_matches_the_oracle_codec(oversize):
    pipe, cases, enc, dec = oversize
    assert pipe.oversize
    assert enc == [encode_block(b) for b in cases]
    assert dec == cases
    assert pipe.reencoded_rows == 0
    assert not DevicePipeline(BS, device="cpu").oversize  # only when forced off the card


def test_oversize_corrupted_payload_raises(oversize):
    pipe, cases, enc, _ = oversize
    i = 1  # the LZP-coded block, whose CM payload is a few dozen bytes
    hdr = parse_block_header(enc[i])
    bad = bytearray(enc[i])
    for k in range(hdr.header_size() + 2, len(bad), 5):
        bad[k] ^= 0x5A
    with pytest.raises(Bz3Error):
        pipe.decode_blocks([(bytes(bad), len(cases[i]))])
