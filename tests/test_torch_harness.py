"""The port's hardening harnesses (``examples/torch_*.py``) on the CPU,
held to the JAX package's numpy oracle (``bzip3_tpu.models.block_codec``,
``bzip3_tpu.ops.ref``) at tolerance 0: the same bytes, or the same error
code.

Volume runs through the port's host C++ stages and engines; the device
path runs with ``device="cpu"`` on a few inputs whose CM rows are at most
512 bytes (the plain CM coder costs ~0.1-0.2 ms a bit step here).  No
JAX function is compiled: the oracle is numpy.
"""

import functools
import os
import sys
from collections import Counter

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import bzip3_tpu  # noqa: E402
import differential_engines as jax_diff  # noqa: E402
import torch_differential_engines as de  # noqa: E402
import torch_fuzz_decode_block as fdb  # noqa: E402
import torch_fuzz_decompress as fdc  # noqa: E402
import torch_fuzz_round_trip as frt  # noqa: E402
import torch_harness as th  # noqa: E402
from bzip3_tpu.errors import Bz3Error as JaxBz3Error  # noqa: E402
from bzip3_tpu.models import block_codec as jax_bc  # noqa: E402
from bzip3_tpu.ops import ref as jax_ref  # noqa: E402

import bzip3_tpu_torch  # noqa: E402
from bzip3_tpu_torch import Bz3Codec  # noqa: E402
from bzip3_tpu_torch.engines import DeviceEngine, NativeEngine  # noqa: E402
from bzip3_tpu_torch.models.block_codec import (  # noqa: E402
    decode_block,
    parse_block_header,
    size_before_bwt,
)
from bzip3_tpu_torch.ops import native  # noqa: E402

BS = fdb.BS


def jax_outcome(fn, *args, **kwargs):
    try:
        r = fn(*args, **kwargs)
    except JaxBz3Error as e:
        return ("err", e.code)
    return ("ok", bytes(r))


class HostStagesEngine:
    """The block codec over the host C++ stages, block by block: the JAX
    oracle engine's semantics (each block's own ``decode_block`` code)."""

    def decode_blocks(self, pairs, block_size):
        return [decode_block(b, o, block_size, native.STAGES) for b, o in pairs]


def _row(block: bytes, osize: int) -> int:
    """The CM row a decode of ``block`` runs (0 where the header fails)."""
    try:
        hdr = parse_block_header(block)
    except Exception:  # noqa: BLE001
        return 0
    return 0 if hdr.is_literal else max(0, size_before_bwt(hdr, osize))


@functools.lru_cache(maxsize=None)
def _fuzz_cases():
    valid, cases = fdb.jax_inputs(0, 60)
    cases += [c for c in fdb.aimed_cases(BS) if _row(*c) <= 16384]
    return valid, cases, [jax_outcome(jax_bc.decode_block, b, o, BS) for b, o in cases]


@pytest.fixture(scope="module")
def fuzz_cases():
    """(the JAX harness's valid block, cases, the JAX oracle's outcome of
    each): its first 60 inputs of seed 0 and the aimed cases whose CM rows
    are at most 16 KiB (a wider one costs ~1.2 s in the numpy oracle).
    Made once a process: ``test_torch_engines.py`` uses them too."""
    return _fuzz_cases()


def test_decode_fuzz_inputs_are_the_jax_harness_inputs(fuzz_cases):
    rng = np.random.default_rng(0)
    seedling = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    assert fuzz_cases[0] == jax_bc.encode_block(seedling)


def test_decode_fuzz_host_stages_equal_jax_oracle(fuzz_cases):
    """The JAX-harness inputs and the aimed cases: the block codec over the
    host C++ stages gives the JAX oracle's bytes or code."""
    codes = set()
    for i, ((block, osize), want) in enumerate(zip(fuzz_cases[1], fuzz_cases[2])):
        got = th.outcome(decode_block, block, osize, BS, native.STAGES)
        assert got == want, (i, got[0], want[0])
        codes.add(got[1] if got[0] == "err" else "ok")
    assert {"ok", -2, -3, -4, -8} <= codes


def test_decode_fuzz_device_cpu_small_rows_equal_jax_oracle(fuzz_cases):
    """``Bz3Codec.decode_block`` on the CPU (K4, K2 and the tensor BWT's
    plain versions) on aimed cases whose CM rows are 1-256 bytes."""
    codec = Bz3Codec(BS, device="cpu")
    small = [c for c in fdb.aimed_cases(BS) if 0 < _row(*c) <= 256]
    assert len(small) >= 12
    stats = Counter()
    for i, (block, osize) in enumerate(small[::8]):
        got = fdb.check_block(0, i, block, osize, codec, "cpu", stats)
        assert got == jax_outcome(jax_bc.decode_block, block, osize, BS), i


@pytest.mark.parametrize("route", ["default", "prepass", "hybrid"])
def test_batch_reference_equals_device_pipeline_on_cpu(route):
    """The harness's batch reference (the pipeline over the host coder) is
    the port's pipeline: on batches of small damaged and intact blocks
    both give the same bytes or the same code, and the native engine the
    same bytes or an error; a decoded batch is the JAX oracle's blocks."""
    cases = [c for c in fdb.aimed_cases(BS) if _row(*c) <= 192]
    rng = np.random.default_rng(3)
    intact = [(fdb.encode(d), len(d)) for d in (b"hello hello hello " * 20, b"ab" * 100)]
    batches = fdb.batches(rng, cases[::5], intact, max_k=4)[:3]
    with fdb.route_env(route):
        eng = DeviceEngine("cpu", device_prepass=route == "prepass", host_crc=True,
                           device_crc_verify=False)
        ref = th.ReferenceEngine(device_prepass=route == "prepass")
        seen = set()
        for j, batch in enumerate(batches):
            got = th.check_batch(0, j, batch, BS, eng, ref, NativeEngine(0), "cpu")
            want = [jax_outcome(jax_bc.decode_block, b, o, BS) for b, o in batch]
            if got[0] == "ok":
                assert list(got[1]) == [w[1] for w in want]
            else:
                assert any(w[0] == "err" for w in want)
            seen.add(got[0])
    assert "err" in seen


def test_batch_reference_volume_against_jax_oracle(fuzz_cases):
    """The reference on every fuzz case in batches: a decoded batch holds
    the JAX oracle's bytes, a failed one a block the oracle rejects."""
    valid, cases, outs = fuzz_cases
    jax_of = {(b, o): w for (b, o), w in zip(cases, outs)}
    jax_of[(valid, 2000)] = jax_outcome(jax_bc.decode_block, valid, 2000, BS)
    rng = np.random.default_rng(1)
    ref, nat = th.ReferenceEngine(), NativeEngine(0)
    for j, batch in enumerate(fdb.batches(rng, cases, [(valid, 2000)])):
        got = th.outcome(ref.decode_blocks, batch, BS)
        assert th.same_verdict(got, th.outcome(nat.decode_blocks, batch, BS)), j
        want = [jax_of[c] for c in batch]
        if got[0] == "ok":
            assert list(got[1]) == [w[1] for w in want], j
        else:
            assert any(w[0] == "err" for w in want), j


def test_frame_fuzz_equals_jax_oracle():
    """The JAX frame harness's first 100 frames of seed 0: the port's frame
    decoder over the host stages gives the JAX oracle's bytes or code,
    and the batch reference the same bytes or an error."""
    valid, blobs = fdc.jax_inputs(0, 100)
    data = np.random.default_rng(0).integers(0, 256, 3000, dtype=np.uint8).tobytes()
    assert valid == bzip3_tpu.compress(data, 65 * 1024, engine=jax_ref)
    eng = fdc.Engines("cpu")
    for i, blob in enumerate(blobs):
        want = jax_outcome(bzip3_tpu.decompress, blob, engine=jax_ref, max_output=fdc.MAX_OUTPUT)
        got = th.outcome(bzip3_tpu_torch.decompress, blob, engine=HostStagesEngine(),
                         max_output=fdc.MAX_OUTPUT)
        assert got == want, i
        ref = th.outcome(bzip3_tpu_torch.decompress, blob, engine=eng.ref,
                         max_output=fdc.MAX_OUTPUT)
        assert th.same_verdict(ref, want), i


def test_round_trip_fuzz_native_equals_jax_oracle():
    """The JAX round-trip harness's inputs of seed 0: the native engine's
    stream is the JAX oracle's, byte for byte, and decodes back."""
    nat = NativeEngine(0)
    for i, data in enumerate(frt.jax_inputs(0, 60)):
        bs = max(65 * 1024, len(data))
        enc = nat.encode_blocks([data], bs)[0]
        assert enc == jax_bc.encode_block(data), i
        assert nat.decode_blocks([(enc, len(data))], bs)[0] == data, i


def test_round_trip_fuzz_device_cpu():
    """The harness's own check through the device engine on the CPU, on
    the inputs whose CM rows are short: a repeated byte and a repeated
    17-byte word of up to 5,000 bytes, and the literal boundary."""
    inputs = frt.jax_inputs(0, 10)
    eng, nat = DeviceEngine("cpu"), NativeEngine(0)
    for i in (2, 4, 8, 9):
        frt.one_input(0, i, inputs[i], eng, nat, "cpu")


def test_differential_data_is_the_jax_harness_data():
    rng = np.random.default_rng(5)
    want = []
    for _ in range(6):
        bs = 66560 if int(rng.integers(0, 2)) == 0 else 131072
        k = int(rng.integers(1, 5))
        want.append((bs, [jax_diff.make_data(rng)[:bs] for _ in range(k)]))
    assert de.trials(5, 6) == want


def test_differential_native_equals_jax_oracle():
    """Three trials of seed 0 (up to 4 blocks of up to 130 KB): the native
    engine's streams are the JAX oracle's."""
    nat = NativeEngine(0)
    for bs, blocks in de.trials(0, 3):
        for data, enc in zip(blocks, nat.encode_blocks(blocks, bs)):
            assert enc == jax_bc.encode_block(data)


def test_differential_routes_on_cpu_small_blocks():
    """One trial through the default, device-prepass and parallel routes
    of the pipeline on the CPU, held to the native engine, every block to
    the oracle engine and, for the rows of at most 64 bytes, the plain
    versions: blocks whose CM rows are short (zeros, a repeated phrase,
    runs, the literal region)."""
    rng = np.random.default_rng(9)
    blocks = [bytes(5000), (b"the quick brown fox " * 150)[:2900],
              rng.integers(0, 256, 40, dtype=np.uint8).tobytes(),
              b"".join(bytes([97 + i % 3]) * (1 + i % 40) for i in range(30))]
    rt = de.Routes("cpu", plain_row=64, oracle=de.OracleLeg())
    de.one_trial(0, 0, 66560, blocks, rt)
    assert rt.plain_blocks == 2  # the zeros' row and the literal
    leg = rt.oracle.finish()
    assert (leg["blocks"], leg["compressed_blocks"], leg["bytes"]) == (4, 3, 5000 + 2900 + 40 + 465)
    assert leg["equal"] == 4
    for data, enc in zip(blocks, rt.nat.encode_blocks(blocks, 66560)):
        assert enc == jax_bc.encode_block(data)


def test_differential_oracle_leg_on_worker_processes():
    """The oracle leg as ``chip_smoke.py``'s ``harden`` runs it, on spawned
    workers: whole blocks checked in ``finish``, a block whose stream
    differs named by its seed and index after every block was checked,
    and the workers stopped."""
    data = [(b"the quick brown fox " * 400)[:7000], bytes(3000) + b"xyz" * 50]
    nat = NativeEngine(0).encode_blocks(data, 66560)
    leg = de.OracleLeg()
    for i, (d, blk) in enumerate(zip(data, nat)):
        leg.submit(7, i, d, blk, 66560, len(d))
    leg.submit(7, 2, data[1], nat[0], 66560, len(data[1]))
    leg.submit(7, 3, data[0], nat[1], 66560, len(data[0]))
    with pytest.raises(th.HarnessFailure, match=r"seed 7 index 2: oracle: encode differs"
                       r"(.|\n)*\(2 of 4 blocks failed the oracle\)"):
        leg.finish()
    with pytest.raises(RuntimeError, match="shutdown"):
        leg.submit(7, 4, data[0], nat[0], 66560, len(data[0]))


def test_differential_oracle_leg_names_a_block_its_worker_raised_on():
    """A worker's exception (here the oracle's ``Bz3Error`` on a block
    whose header the card would have garbled) comes out of ``finish`` as
    a ``HarnessFailure`` naming the block's seed and index."""
    data = (b"the quick brown fox " * 400)[:7000]
    blk = NativeEngine(0).encode_blocks([data], 66560)[0]
    leg = de.OracleLeg()
    leg.submit(3, 0, data, blk, 66560, len(data))
    leg.submit(3, 5, data, blk[:9] + b"\xff" * 4 + blk[13:], 66560, len(data))
    with pytest.raises(th.HarnessFailure, match=r"seed 3 index 5: Bz3Error: Malformed header"
                       r"(.|\n)*\(1 of 2 blocks failed the oracle\)"):
        leg.finish()


def test_make_corpus_is_bench_corpus():
    from bench import make_corpus

    for size, seed in ((0, 0), (1000, 1), (70000, 2)):
        assert th.make_corpus(size, seed) == make_corpus(size, seed)


def test_harness_failure_names_seed_and_index():
    def boom():
        raise IndexError("index 7 is out of bounds")

    with pytest.raises(th.HarnessFailure, match="seed 4 index 2: IndexError"):
        th.trial(4, 2, boom)
    with pytest.raises(th.HarnessFailure, match="seed 4 index 3: differs"):
        th.require(False, 4, 3, "differs")


def test_harnesses_ask_for_the_card_by_default():
    """Without ``--device cpu`` the harnesses want the card, and a machine
    without one raises instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        th.split_device(["0", "10"])
    dev, rest = th.split_device(["0", "--device", "cpu", "10"])
    assert dev.type == "cpu" and rest == ["0", "10"]
