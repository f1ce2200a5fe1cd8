"""The port's engine registry on the CPU: the native engine (host C++
pool) against the JAX package's native engine and the port's device
engine, the hybrid engine against the native one, the oracle engine
(the block codec over ``ops/ref``) against the JAX oracle engine on
intact and damaged blocks, and ``get_engine``'s names.  Streams must be byte-identical and the
native engine must reject damaged blocks with the JAX native engine's
codes.  Blocks are KiB-sized or collapse under RLE and LZP, so that the
plain CM coder of the CPU device engine stays cheap.
"""

import os

import numpy as np
import pytest

from bzip3_tpu.engines import NativeEngine as JaxNative
from bzip3_tpu.engines import OracleEngine as JaxOracle
from bzip3_tpu.errors import Bz3Error as JaxBz3Error
from bzip3_tpu.ops.native import NativeCodec as JaxNativeCodec
from bzip3_tpu_torch.engines import (
    DeviceEngine,
    HybridEngine,
    NativeEngine,
    OracleEngine,
    get_engine,
)
from bzip3_tpu_torch.errors import Bz3Error
from bzip3_tpu_torch.ops import build, native, ref
from fixtures import sample_mixed, sample_text
from test_torch_harness import fuzz_cases  # noqa: F401 -- a fixture here too, at 65 KiB

BS = 65 * 1024
RNG = np.random.default_rng(5)
MIXED = sample_mixed()
BLOCKS = [
    MIXED[30000 : 30000 + BS],
    b"the quick brown fox " * 3000,
    sample_text()[:400],
    b"x" * 40,
    b"",
    bytes(RNG.integers(0, 256, 300, dtype=np.uint8)),
]


@pytest.fixture(scope="module")
def jax_blocks():
    return JaxNative(2).encode_blocks(BLOCKS)


@pytest.fixture(scope="module")
def port_native():
    return NativeEngine(3)


def test_native_equals_jax_native_and_device(port_native, jax_blocks):
    enc = port_native.encode_blocks(BLOCKS, BS)
    assert enc == jax_blocks
    assert DeviceEngine("cpu").encode_blocks(BLOCKS, BS) == enc
    pairs = [(e, len(b)) for e, b in zip(enc, BLOCKS)]
    assert port_native.decode_blocks(pairs, BS) == BLOCKS
    assert JaxNative(2).decode_blocks(pairs, BS) == BLOCKS


@pytest.mark.parametrize("n_threads", [0, 1, 4, 64])
def test_native_thread_counts(jax_blocks, n_threads):
    eng = NativeEngine(n_threads)
    assert eng.encode_blocks(BLOCKS) == jax_blocks
    assert eng.decode_blocks([(e, len(b)) for e, b in zip(jax_blocks, BLOCKS)], BS) == BLOCKS


def _damage(blk: bytes, case: str) -> tuple[bytes, int]:
    b = bytearray(blk)
    n = len(BLOCKS[0])
    if case == "crc":
        b[0] ^= 1
    elif case == "payload":
        b[len(b) // 2 + 10] ^= 0x77
    elif case == "bwt_idx":
        b[4:8] = (10**6).to_bytes(4, "little")
    elif case == "bwt_idx_zero":
        b[4:8] = bytes(4)
    elif case == "model":
        b[8] = 2
    elif case == "truncated":
        return bytes(b[:7]), n
    elif case == "truncated_header":
        return bytes(b[:12]), n
    elif case == "orig_size":
        return bytes(b), n + 1
    elif case == "orig_size_past_bound":
        return bytes(b), BS * 2
    return bytes(b), n


CORRUPTIONS = ["crc", "payload", "bwt_idx", "bwt_idx_zero", "model", "truncated",
               "truncated_header", "orig_size", "orig_size_past_bound"]


def _codes(eng, pairs):
    try:
        return ("ok", eng.decode_blocks(pairs, BS))
    except (Bz3Error, JaxBz3Error) as e:
        return ("error", e.code)


@pytest.mark.parametrize("case", CORRUPTIONS)
def test_native_rejects_corruption_like_jax(port_native, jax_blocks, case):
    blk, n = _damage(jax_blocks[0], case)
    pairs = [(jax_blocks[1], len(BLOCKS[1])), (blk, n)]
    got = _codes(port_native, pairs)
    assert got == _codes(JaxNative(2), pairs)
    assert got[0] == "error"


@pytest.mark.parametrize("case", ["intact"] + CORRUPTIONS)
def test_native_codec_equals_jax_native_codec(jax_blocks, case):
    """``ops.native.NativeCodec``, one block a call: the JAX package's
    ``NativeCodec`` bytes, and its error code on each damaged block."""
    codec, jcodec = native.NativeCodec(BS), JaxNativeCodec(BS)
    assert codec.encode_block(BLOCKS[0]) == jcodec.encode_block(BLOCKS[0]) == jax_blocks[0]
    blk, n = (jax_blocks[0], len(BLOCKS[0])) if case == "intact" else _damage(jax_blocks[0], case)

    def one(c):
        try:
            return ("ok", c.decode_block(blk, n))
        except (Bz3Error, JaxBz3Error) as e:
            return ("error", e.code)

    got = one(codec)
    assert got == one(jcodec)
    assert got == ("ok", BLOCKS[0]) if case == "intact" else got[0] == "error"


def test_native_module_stage_names_are_the_host_stages():
    data = BLOCKS[1][:5000] + bytes(RNG.integers(0, 256, 500, dtype=np.uint8))
    for name in ("crc32", "rle_encode", "lzp_encode", "bwt_forward", "cm_encode"):
        fn = getattr(native, name)
        assert fn is getattr(native.STAGES, name)
        assert fn(data) == getattr(ref, name)(data), name
    u, idx = native.bwt_forward(data)
    assert native.bwt_inverse(u, idx) == data
    assert native.rle_decode(native.rle_encode(data), len(data)) == data
    assert native.lzp_decode(native.lzp_encode(data), len(data)) == data


@pytest.mark.parametrize("share", [0.5, 1.0, 0.0])
def test_hybrid_equals_native(monkeypatch, port_native, jax_blocks, share):
    monkeypatch.setenv("BZ3_TPU_HYBRID_MIN_MIB", "0")
    hyb = HybridEngine(2, device_share=share, device="cpu")
    assert hyb.encode_blocks(BLOCKS, BS) == jax_blocks
    pairs = [(e, len(b)) for e, b in zip(jax_blocks, BLOCKS)]
    assert hyb.decode_blocks(pairs, BS) == BLOCKS


def test_hybrid_gate_and_share(monkeypatch):
    monkeypatch.delenv("BZ3_TPU_HYBRID_MIN_MIB", raising=False)
    monkeypatch.setenv("BZ3_TPU_HYBRID_SHARE", "0.25")
    hyb = HybridEngine(device="cpu")
    assert hyb.device_share == 0.25
    calls = []
    out = hyb._run([b"a", b"b"], BS, lambda *a: calls.append("dev") or [],
                   lambda items, bs: calls.append("nat") or list(items))
    assert out == [b"a", b"b"] and calls == ["nat"]  # under 1 GiB: native alone
    assert HybridEngine(device="cpu", device_share=7).device_share == 1.0


@pytest.mark.parametrize("i", range(len(BLOCKS)))
def test_oracle_engine_equals_native(jax_blocks, i):
    """Each block of ``BLOCKS`` (65 KiB of mixed data, text, runs, the
    literal region, the empty block): the native engines' bytes, which
    are the JAX oracle engine's, and back; recover mode's stage namespace
    is the spec itself."""
    eng = OracleEngine()
    assert eng.stages is ref
    enc = eng.encode_blocks([BLOCKS[i]], BS)
    assert enc == JaxOracle().encode_blocks([BLOCKS[i]]) == [jax_blocks[i]]
    assert eng.decode_blocks([(enc[0], len(BLOCKS[i]))], BS) == [BLOCKS[i]]


def test_oracle_engine_decodes_damaged_blocks_like_jax_oracle(fuzz_cases):
    """The JAX decode harness's damaged blocks and the aimed cases: the
    same bytes, or the same ``Bz3Error`` code, block by block."""
    eng = OracleEngine()
    codes = set()
    for i, ((block, osize), want) in enumerate(zip(fuzz_cases[1], fuzz_cases[2])):
        got = _codes(eng, [(block, osize)])
        assert got == (("ok", [want[1]]) if want[0] == "ok" else ("error", want[1])), i
        codes.add(got[1] if got[0] == "error" else "ok")
    assert {"ok", -2, -3, -4, -8} <= codes


def test_get_engine_names():
    assert isinstance(get_engine("auto"), NativeEngine)
    assert isinstance(get_engine("native", 2), NativeEngine)
    assert isinstance(get_engine("oracle"), OracleEngine)
    assert isinstance(get_engine("device", device="cpu"), DeviceEngine)
    hyb = get_engine("hybrid", device="cpu")
    assert isinstance(hyb, HybridEngine) and hyb.stages is native.STAGES
    sharded = get_engine("sharded", device="cpu")
    assert isinstance(sharded, DeviceEngine) and sharded.name == "sharded"
    with pytest.raises(ValueError, match="unknown engine"):
        get_engine("tpu")


def test_host_library_rebuilds_when_a_source_changes(tmp_path):
    """The host library (with the pool, linked -pthread) is stale when
    host_codec.cpp, or any of its sources, is newer than it."""
    assert [os.path.basename(p) for p in build.HOST_SOURCES] == [
        "host_stages.cpp", "host_bwt.cpp", "host_codec.cpp"]
    so, src = tmp_path / "lib.so", tmp_path / "host_codec.cpp"
    src.write_text("")
    so.write_bytes(b"")
    os.utime(src, (100, 100))
    os.utime(so, (200, 200))
    assert not build._stale(str(so), [str(src)])
    os.utime(src, (300, 300))
    assert build._stale(str(so), [str(src)])
    assert build._stale(str(tmp_path / "missing.so"), [str(src)])
