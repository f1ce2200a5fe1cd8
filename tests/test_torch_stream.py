"""The port's stream and frame containers against the JAX package's, on
the CPU: test and recover modes, the recover-mode file header and the
frame's output bound.

The port decodes whole streams through its native engine (the host C++
pool) and its device engine on the CPU; the JAX side runs its oracle
engine.  A damaged block in recover mode goes through the engine's stage
namespace (``engine.stages``).  The tolerance is zero: equal bytes, equal
(read, written), equal error codes and the same "Writing invalid block."
lines.  Blocks are 65 KiB of data that RLE and LZP collapse.
"""

import io
import struct

import pytest

from bzip3_tpu.container import frame as jax_frame
from bzip3_tpu.container import stream as jax_stream
from bzip3_tpu.errors import Bz3Error as JaxBz3Error
from bzip3_tpu_torch.container import frame as port_frame
from bzip3_tpu_torch.container import stream as port_stream
from bzip3_tpu_torch.engines import DeviceEngine, NativeEngine
from bzip3_tpu_torch.errors import Bz3Error
from fixtures import sample_mixed

BS = 65 * 1024
MIXED = sample_mixed()
# three blocks: zeros and random bytes, zeros, a repeated phrase
DATA = MIXED[30000 : 30000 + 2 * BS] + (b"the quick brown fox " * 3400)[: BS - 1000]
WARN = "bzip3: Writing invalid block."


@pytest.fixture(scope="module")
def stream():
    buf = io.BytesIO()
    jax_stream.compress_file(io.BytesIO(DATA), buf, BS)
    return buf.getvalue()


def chunk_offsets(raw: bytes) -> list[int]:
    """Offset of each block (past its 8-byte chunk header) in a stream."""
    out, pos = [], 9
    while pos < len(raw):
        csize = struct.unpack_from("<I", raw, pos)[0]
        out.append(pos + 8)
        pos += 8 + csize
    return out


@pytest.fixture(scope="module")
def damaged(stream):
    """Block 0 with a payload byte flipped, block 2 with its stored CRC
    flipped."""
    raw = bytearray(stream)
    offs = chunk_offsets(stream)
    assert len(offs) == 3
    raw[offs[0] + 30] ^= 0xFF
    raw[offs[2] + 1] ^= 0x10
    return bytes(raw)


@pytest.fixture(scope="module", params=["native", "device_cpu"])
def engine(request):
    return NativeEngine(2) if request.param == "native" else DeviceEngine("cpu")


def _run(fn):
    try:
        return ("ok", fn())
    except (Bz3Error, JaxBz3Error) as e:
        return ("error", e.code)


def test_port_stream_equals_jax(stream, engine):
    buf = io.BytesIO()
    port_stream.compress_file(io.BytesIO(DATA), buf, BS, engine=engine)
    assert buf.getvalue() == stream


def test_test_file_equals_jax(stream, damaged, engine):
    for raw in (stream, damaged):
        want = _run(lambda: jax_stream.test_file(io.BytesIO(raw)))
        got = _run(lambda: port_stream.test_file(io.BytesIO(raw), engine))
        assert got == want
    assert want[0] == "error"


def test_recover_file_equals_jax(damaged, engine, capsys):
    capsys.readouterr()
    want_out = io.BytesIO()
    want = jax_stream.recover_file(io.BytesIO(damaged), want_out)
    want_err = capsys.readouterr().err
    got_out = io.BytesIO()
    got = port_stream.recover_file(io.BytesIO(damaged), got_out, engine, batch_size=3)
    got_err = capsys.readouterr().err
    assert got == want
    assert got_out.getvalue() == want_out.getvalue()
    assert len(got_out.getvalue()) == len(DATA)
    # the intact block and the CRC-flipped one come back whole
    assert got_out.getvalue()[BS:] == DATA[BS:]
    assert got_out.getvalue()[:BS] != DATA[:BS]
    assert got_err.count(WARN) == want_err.count(WARN) == 2


def test_read_file_header_recover():
    for raw in (b"BZ3v1" + struct.pack("<I", 1024), b"BZ3v1" + struct.pack("<I", 512 << 20),
                b"BZ3v1" + struct.pack("<I", BS), b"BZ3v2" + struct.pack("<I", BS),
                b"BZ3v1\x00"):
        for recover in (False, True):
            want = _run(lambda: jax_stream.read_file_header(io.BytesIO(raw), recover))
            got = _run(lambda: port_stream.read_file_header(io.BytesIO(raw), recover))
            assert got == want, (raw, recover)
    assert port_stream.read_file_header(io.BytesIO(b"BZ3v1\x00\x04\x00\x00"), True) == 511 << 20


def test_recover_with_invalid_block_size(stream, capsys):
    """A header block size out of range reads as 511 MiB in recover mode;
    the blocks still decode (KiB blocks, the CPU device engine)."""
    raw = stream[:5] + struct.pack("<I", 1000) + stream[9:]
    with pytest.raises(Bz3Error):
        port_stream.decompress_file(io.BytesIO(raw), io.BytesIO(), DeviceEngine("cpu"))
    want_out = io.BytesIO()
    want = jax_stream.recover_file(io.BytesIO(raw), want_out)
    got_out = io.BytesIO()
    got = port_stream.recover_file(io.BytesIO(raw), got_out, DeviceEngine("cpu"), 3)
    assert got == want
    assert got_out.getvalue() == want_out.getvalue() == DATA
    assert WARN not in capsys.readouterr().err


@pytest.fixture(scope="module")
def frame():
    return jax_frame.compress(DATA, BS, batch_size=4)


@pytest.mark.parametrize("cut", [0, 1, BS, BS + 1, 2 * BS, len(DATA) - 1, len(DATA), None])
def test_decompress_max_output_equals_jax(frame, cut):
    want = _run(lambda: jax_frame.decompress(frame, max_output=cut))
    got = _run(lambda: port_frame.decompress(frame, NativeEngine(), max_output=cut))
    assert got == want
    assert got[0] == ("ok" if cut is None or cut >= len(DATA) else "error")


@pytest.mark.parametrize("cut", [0, BS, 2 * BS - 1, 2 * BS, len(DATA)])
def test_max_output_raises_before_a_later_truncation(frame, cut):
    """The bound is checked as each block's header is read, after that
    block's own truncation check: a bound passed in the first two blocks
    raises DATA_TOO_BIG before the truncated third block is seen."""
    short = frame[:-5]
    want = _run(lambda: jax_frame.decompress(short, max_output=cut))
    got = _run(lambda: port_frame.decompress(short, NativeEngine(), max_output=cut))
    assert got == want
