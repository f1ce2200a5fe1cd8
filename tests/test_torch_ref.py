"""The port's executable spec (``bzip3_tpu_torch/ops/ref``) against the
JAX package's (``bzip3_tpu/ops/ref``), the port's plain tensor versions
(``block_stages("cpu")``) and the reference-made golden streams.

Tolerance 0: equal bytes, equal index, equal arrays.  The inputs are
seeded and KiB-sized, and cover each stage's edges: empty, one byte and
under 64 bytes; runs of 4+ and 255+; a stream ending inside a run's
length (F3); LZP matches of 40+ bytes; an exhausted CM stream; suffix
and LCP arrays of random and repetitive bytes.
"""

import ast
import io
import os
import sys

import numpy as np
import pytest

from bzip3_tpu.ops import ref as jref
from bzip3_tpu.ops.ref import cm_parallel as jcm_parallel
from bzip3_tpu.ops.ref import lcp as jlcp
from bzip3_tpu.ops.ref.bwt import suffix_array as jsuffix_array
from bzip3_tpu_torch.container.stream import compress_file, decompress_file
from bzip3_tpu_torch.engines import OracleEngine
from bzip3_tpu_torch.ops import native, ref
from bzip3_tpu_torch.ops.device.stages import block_stages
from bzip3_tpu_torch.ops.ref import cm_parallel, lcp
from bzip3_tpu_torch.ops.ref.bwt import suffix_array
from fixtures import sample_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(14)
PLAIN = block_stages("cpu")
PHRASE = RNG.integers(32, 127, 150, dtype=np.uint8).tobytes()


def _rand(n: int, lo: int = 0, hi: int = 256) -> bytes:
    return RNG.integers(lo, hi, n, dtype=np.uint8).tobytes()


CASES = {
    "empty": b"",
    "one": b"\x07",
    "short": _rand(40),
    "literal_edge": _rand(63),
    "runs4": b"".join(bytes([97 + i % 5]) * (4 + i % 7) for i in range(120)),
    "runs255": b"A" * 600 + b"B" * 255 + b"C" * 256 + b"\xff" * 300 + b"D" * 3,
    "lzp40": PHRASE * 9 + _rand(80) + PHRASE[:60] + b"\xf2" * 3 + PHRASE,
    "lzp_tokens": (b"\xf2" + PHRASE[:50]) * 12,
    "random": _rand(1024),
    "alphabet": _rand(1500, 97, 100),
    "text": sample_text()[:2048],
}
PLAIN_CM = 160  # bytes of a case the plain CM codes (~0.15 ms a bit step on the CPU)


def test_exports_are_the_jax_oracles_nine_stages():
    assert ref.__all__ == jref.__all__
    assert len(ref.__all__) == 9 and all(callable(getattr(ref, n)) for n in ref.__all__)


def test_ref_imports_numpy_and_the_standard_library_only():
    """No torch, no JAX, nothing of either package: the spec stands alone."""
    folder = os.path.join(ROOT, "bzip3_tpu_torch", "ops", "ref")
    files = sorted(f for f in os.listdir(folder) if f.endswith(".py"))
    assert files == ["__init__.py", "bwt.py", "cm.py", "cm_parallel.py", "crc32.py",
                     "lcp.py", "lzp.py", "rle.py"]
    for f in files:
        with open(os.path.join(folder, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top == "numpy" or top in sys.stdlib_module_names, (f, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_crc32_equals_jax_oracle_plain_and_host(case):
    data = CASES[case]
    want = jref.crc32(data)
    assert ref.crc32(data) == want == PLAIN.crc32(data) == native.crc32(data)
    assert ref.crc32(data, 0xDEADBEEF) == jref.crc32(data, 0xDEADBEEF)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rle_equals_jax_oracle_and_plain(case):
    data = CASES[case]
    enc = ref.rle_encode(data)
    assert enc == jref.rle_encode(data)
    if len(enc) <= len(data) + 64:  # the plain version's row holds its stream
        assert enc == PLAIN.rle_encode(data)
    assert ref.rle_decode(enc, len(data)) == data == PLAIN.rle_decode(enc, len(data))
    for cut in (len(enc) - 1, 33, 31):  # streams cut short: decoded or refused alike
        want = jref.rle_decode(enc[:cut], len(data))
        assert ref.rle_decode(enc[:cut], len(data)) == want, cut
        if cut >= 32:
            assert PLAIN.rle_decode(enc[:cut], len(data)) == want, cut


@pytest.mark.parametrize("stream,out_len", [
    (b"\xff" * 32 + b"a\xff", 1),  # F3: the run ends inside its length bytes
    (b"\xff" * 32 + b"a" + b"\xff" * 40, 64),
    (b"\xff" * 32 + b"a", 1),
    (b"\xff" * 32 + b"a\xff", 2),
    (b"\x00" * 32 + b"xyz", 3),
    (b"\x00" * 31, 0),
])
def test_rle_decode_terminator_rule_equals_jax_oracle_and_plain(stream, out_len):
    want = jref.rle_decode(stream, out_len)
    assert ref.rle_decode(stream, out_len) == want
    if len(stream) >= 32:
        assert PLAIN.rle_decode(stream, out_len) == want
    if stream == b"\xff" * 32 + b"a\xff" and out_len == 1:
        assert want == b"a"


@pytest.mark.parametrize("case", sorted(CASES))
def test_lzp_equals_jax_oracle_plain_and_host(case):
    data = CASES[case]
    enc = ref.lzp_encode(data)
    assert enc == jref.lzp_encode(data) == PLAIN.lzp_encode(data) == native.STAGES.lzp_encode(data)
    if enc is None:
        return
    cap = len(data) + 64
    assert ref.lzp_decode(enc, cap) == data == PLAIN.lzp_decode(enc, cap)
    for stream, max_out in ((enc, len(data) // 2), (enc[:-1], cap), (enc[:5], cap)):
        want = jref.lzp_decode(stream, max_out)
        assert ref.lzp_decode(stream, max_out) == want == PLAIN.lzp_decode(stream, max_out)


def test_lzp_matches_of_40_bytes_and_more_are_tokens():
    data = CASES["lzp40"]
    enc = ref.lzp_encode(data)
    assert enc is not None and len(enc) < len(data) - 500
    assert 0xF2 in enc
    # a truncated token stream is refused by every version
    i = enc.index(0xF2, 4)
    assert ref.lzp_decode(enc[: i + 1], len(data)) is None
    assert jref.lzp_decode(enc[: i + 1], len(data)) is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwt_equals_jax_oracle_and_plain(case):
    data = CASES[case]
    u, idx = ref.bwt_forward(data)
    assert (u, idx) == jref.bwt_forward(data) == PLAIN.bwt_forward(data)
    assert ref.bwt_inverse(u, idx) == data
    n = len(u)
    for index in sorted({-1, 0, 1, idx, n // 2, n, n + 1}):
        want = jref.bwt_inverse(u, index)
        assert ref.bwt_inverse(u, index) == want, index
        assert PLAIN.bwt_inverse(u, index) == want, index


def _brute_suffix_array(data: bytes) -> list[int]:
    return sorted(range(len(data)), key=lambda i: data[i:])


@pytest.mark.parametrize("data", [
    _rand(700), _rand(900, 97, 99), b"ab" * 300, b"\x00" * 257, PHRASE * 5, b"z", b"",
])
def test_suffix_array_and_lcp_equal_jax_oracle_and_brute_force(data):
    buf = np.frombuffer(data, np.uint8)
    sa = suffix_array(buf)
    np.testing.assert_array_equal(sa, jsuffix_array(buf))
    assert sa.tolist() == _brute_suffix_array(data)
    if len(data) < 2:
        return
    want = [0] + [
        next((k for k in range(len(data)) if data[a + k : a + k + 1] != data[b + k : b + k + 1]),
             len(data))
        for a, b in zip(sa[1:].tolist(), sa[:-1].tolist())
    ]
    got = lcp.lcp_array(data, sa)
    np.testing.assert_array_equal(got, jlcp.lcp_array(data, sa))
    np.testing.assert_array_equal(lcp.plcp_array(data, sa), jlcp.plcp_array(data, sa))
    assert got.tolist() == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_cm_equals_jax_oracle_host_and_plain(case):
    """Whole cases against the JAX oracle and the host coder; their first
    ``PLAIN_CM`` bytes against the plain versions too."""
    data = CASES[case]
    enc = ref.cm_encode(data)
    assert enc == jref.cm_encode(data) == native.cm_encode(data)
    assert ref.cm_decode(enc, len(data)) == data == jref.cm_decode(enc, len(data))
    head = data[:PLAIN_CM]
    enc = ref.cm_encode(head)
    assert enc == PLAIN.cm_encode(head)
    assert ref.cm_decode(enc, len(head)) == head == PLAIN.cm_decode(enc, len(head))


@pytest.mark.parametrize("keep", [0, 1, 3, 9])
def test_cm_decode_of_an_exhausted_stream_equals_jax_oracle_and_plain(keep):
    """Past its payload the decoder shifts in ``(code << 8) - 1``, the
    reference's underread: a stream cut to ``keep`` bytes still decodes
    to the same garbage in every version."""
    data = CASES["text"][:PLAIN_CM]
    payload = ref.cm_encode(data)[:keep]
    want = jref.cm_decode(payload, len(data))
    got = ref.cm_decode(payload, len(data))
    assert got == want == PLAIN.cm_decode(payload, len(data)) == native.cm_decode(payload, len(data))
    assert len(got) == len(data)


@pytest.mark.parametrize("case,seg", [("text", 512), ("text", 64), ("runs4", 32),
                                      ("random", 128), ("empty", 512), ("one", 512)])
def test_cm_parallel_equals_jax_oracle_and_serial_coder(case, seg):
    data = CASES[case][:384]
    got = cm_parallel.cm_encode_parallel(data, seg)
    assert got == jcm_parallel.cm_encode_parallel(data, seg)
    if data:
        assert got == ref.cm_encode(data)


def test_chain_values_segmented_equal_jax_oracle():
    dirs = RNG.integers(0, 2, 5000).astype(np.int64)
    for rate, init in ((2, 1 << 15), (4, 0), (6, 65535)):
        got = cm_parallel._chain_values_segmented(init, dirs, rate, seg=256)
        np.testing.assert_array_equal(got, jcm_parallel._chain_values_segmented(init, dirs, rate,
                                                                               seg=256))
        np.testing.assert_array_equal(got, cm_parallel._chain_values(init, dirs, rate))


def test_oracle_engine_reproduces_the_golden_stream():
    """``sample_text.bin.bz3`` (made by the reference, ``-b 1``): the
    oracle engine encodes the text to it and decodes it back."""
    data = sample_text()
    with open(os.path.join(ROOT, "tests", "data", "sample_text.bin.bz3"), "rb") as f:
        gold = f.read()
    out = io.BytesIO()
    compress_file(io.BytesIO(data), out, 1 << 20, engine=OracleEngine())
    assert out.getvalue() == gold
    dec = io.BytesIO()
    decompress_file(io.BytesIO(gold), dec, engine=OracleEngine())
    assert dec.getvalue() == data
