"""The port's parallel CM encoder (``ops/device/cm_parallel.py`` over the
wrappers of ``cm_parallel_cuda.py``, which take the plain versions of P1
and P2 on CPU tensors, and its row groups) against the JAX package: its serial chain values
(``ops/ref/cm_parallel.py``), its ``cm_encode_parallel_batch`` on the
CPU and the oracle coder (``ops/ref/cm.py``); then the pipeline's
``BZ3_TPU_CM`` switch, its row groups and its ``ok`` contract against the
JAX block codec.

Bytes and integers, so the tolerance is 0.  The rows are the JAX
package's own hazards (``tests/test_device_ops.py``): skewed ``b"aab"``
and text after the BWT at ``seg=128``, where many windows hand brackets
on; rows of differing lengths, and an empty one.  One JAX call a shape
and mode (each compiles for some seconds here).
"""

import contextlib

import numpy as np
import pytest
import torch

from bzip3_tpu.models.block_codec import encode_block as jax_encode_block
from bzip3_tpu.ops.device.cm_parallel import cm_encode_parallel_batch as jax_parallel
from bzip3_tpu.ops.ref.bwt import bwt_forward as ref_bwt
from bzip3_tpu.ops.ref.cm import cm_encode as ref_cm_encode
from bzip3_tpu.ops.ref.cm_parallel import _chain_values as ref_chain_values
from bzip3_tpu_torch import pipeline
from bzip3_tpu_torch.ops.device import cm_parallel, cm_parallel_cuda
from bzip3_tpu_torch.pipeline import DevicePipeline

N = 1024


def _pad(rows, width):
    arr = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return arr, lens


def _no_stage(name):
    return contextlib.nullcontext()


# -- per-event chain values ---------------------------------------------

def _events(rate: int, seed: int):
    """Two rows of 4,096 events over 12 slots (long chains that cross
    windows) and SENT-keyed inactive events, times a permutation; at rate
    4 half the events read without advancing, as C1's reads do."""
    rng = np.random.default_rng(seed)
    k, e = 2, 4096
    keys = rng.integers(0, 12, (k, e)) * 37
    keys[rng.random((k, e)) < 0.05] = cm_parallel.SENT
    times = np.stack([rng.permutation(e) for _ in range(k)])
    bits = rng.random((k, e)) < np.where(keys % 2, 0.8, 0.3)
    adv = rng.random((k, e)) < 0.5 if rate == 4 else np.ones((k, e), bool)
    init = (keys * 131) % 65536
    return keys, times, bits, adv, init


def _serial(keys, times, bits, adv, init, rate):
    """Each slot group's chain in time order, serially: the reference's
    ``_chain_values`` where every event advances, else a loop in which
    reads see the value and leave it."""
    want = np.zeros(keys.shape, np.int64)
    for r in range(keys.shape[0]):
        for slot in np.unique(keys[r]):
            if slot == cm_parallel.SENT:
                continue
            idx = np.flatnonzero(keys[r] == slot)
            idx = idx[np.argsort(times[r, idx])]
            if adv[r, idx].all():
                want[r, idx] = ref_chain_values(int(init[r, idx[0]]), bits[r, idx], rate)
                continue
            p = int(init[r, idx[0]])
            for i in idx:
                want[r, i] = p
                if adv[r, i]:
                    p = p + ((p ^ 65535) >> rate) if bits[r, i] else p - (p >> rate)
    return want


@pytest.mark.parametrize("speculative", [True, False])
@pytest.mark.parametrize("seg", [128, 2048])
@pytest.mark.parametrize("rate", [2, 4, 6])
def test_chain_values_equal_serial_chains(rate, seg, speculative):
    keys, times, bits, adv, init = _events(rate, seed=rate * 7 + seg)
    got, ok = cm_parallel._chain(
        torch.from_numpy(keys).int(), torch.from_numpy(times), torch.from_numpy(bits),
        torch.from_numpy(adv), torch.from_numpy(init).int(), rate, seg, speculative,
        cm_parallel_cuda.chain_windows, _no_stage)
    assert ok.all()
    live = keys != cm_parallel.SENT
    want = _serial(keys, times, bits, adv, init, rate)
    np.testing.assert_array_equal(got.numpy()[live], want[live])


# -- the encoder against JAX and the oracle ---------------------------------

@pytest.fixture(scope="module")
def hazard_rows(text_data):
    rng = np.random.default_rng(77)
    skew = rng.choice(np.frombuffer(b"aab", np.uint8), size=N, p=[0.6, 0.3, 0.1]).tobytes()
    return [
        ref_bwt(skew)[0],
        ref_bwt(text_data[:N])[0],
        ref_bwt(text_data[N : N + 500])[0],
        b"",
        rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
    ]


CONFIGS = [(128, True), (2048, True), (128, False)]


@pytest.fixture(scope="module")
def jax_outputs(hazard_rows):
    arr, lens = _pad(hazard_rows, N)
    return {
        (seg, spec): tuple(np.asarray(x) for x in jax_parallel(arr, lens, seg=seg, speculative=spec))
        for seg, spec in CONFIGS
    }


@pytest.mark.parametrize("seg,speculative", CONFIGS)
def test_encoder_equals_jax_and_oracle(hazard_rows, jax_outputs, seg, speculative):
    arr, lens = _pad(hazard_rows, N)
    out, olens, ok = cm_parallel.cm_encode_parallel_batch(
        torch.from_numpy(arr), torch.from_numpy(lens), seg=seg, speculative=speculative)
    jout, jlens, jok = jax_outputs[(seg, speculative)]
    assert out.shape == jout.shape
    np.testing.assert_array_equal(olens.numpy(), jlens)
    np.testing.assert_array_equal(ok.numpy(), jok)
    assert ok.all()
    for i, row in enumerate(hazard_rows):
        got = out[i, : olens[i]].numpy().tobytes()
        assert got == jout[i, : jlens[i]].tobytes() == ref_cm_encode(row), f"row {i}"


def test_encoder_caps_output_and_reports_true_length(hazard_rows):
    """A payload past out_width: its true length, its bytes under the cap
    exact, ok False (the caller codes it again)."""
    arr, lens = _pad(hazard_rows[3:], 300)
    out, olens, ok = cm_parallel.cm_encode_parallel_batch(
        torch.from_numpy(arr), torch.from_numpy(lens), seg=128, out_width=200)
    want = [ref_cm_encode(r) for r in hazard_rows[3:]]
    assert olens.tolist() == [len(w) for w in want]
    assert ok.tolist() == [True, False]
    assert out[1].numpy().tobytes() == want[1][:200]


def test_row_groups_give_the_same_bytes(hazard_rows, monkeypatch):
    rows = [r[:160] for r in hazard_rows]
    arr, lens = (torch.from_numpy(a) for a in _pad(rows, 160))
    whole = cm_parallel_cuda.cm_encode_parallel(arr, lens, seg=128)
    for group in (160, 320):  # 1 and 2 rows a group
        monkeypatch.setattr(cm_parallel_cuda, "GROUP_BYTES", group)
        parts = cm_parallel_cuda.cm_encode_parallel(arr, lens, seg=128)
        for a, b in zip(parts, whole):
            assert torch.equal(a, b)
    for i, r in enumerate(rows):
        assert whole[0][i, : whole[1][i]].numpy().tobytes() == ref_cm_encode(r)


# -- the pipeline's switch and ok contract ----------------------------------

BS = 65536


@pytest.fixture(scope="module")
def blocks(text_data):
    """Blocks of a 65,536-byte block size whose rows RLE and LZP collapse
    to some hundred bytes (the plain coders take ~1 ms a byte here), a
    literal and a short random row."""
    rng = np.random.default_rng(5)
    return [
        (text_data[:300] * 220)[:BS],
        b"".join(bytes([i % 7 + 97]) * (i % 5 + 1) for i in range(20000))[:BS],
        b"x" * 40,
        rng.integers(0, 256, 200, dtype=np.uint8).tobytes(),
        (b"abcdefgh" * 9000)[:BS],
    ]


@pytest.fixture(scope="module")
def jax_blocks(blocks):
    return [jax_encode_block(b) for b in blocks]


def _encode(blocks, monkeypatch, mode):
    monkeypatch.setenv("BZ3_TPU_CM", mode)
    pipe = DevicePipeline(BS, device="cpu")
    return pipe, pipe.encode_blocks(blocks)


class _Routed(Exception):
    pass


class _Calls(list):
    stop = False


@pytest.fixture
def spy(monkeypatch):
    """Calls of the parallel encoder from the pipeline (their shapes);
    with ``spy.stop`` set, a call raises ``_Routed`` instead of coding."""
    calls = _Calls()
    real = cm_parallel_cuda.cm_encode_parallel

    def wrapped(u, lens, **kw):
        calls.append(tuple(u.shape))
        if calls.stop:
            raise _Routed
        return real(u, lens, **kw)

    monkeypatch.setattr(cm_parallel_cuda, "cm_encode_parallel", wrapped)
    return calls


@pytest.mark.parametrize("mode,impl", [("auto", "k1"), ("pallas", "k1"), ("scan", "k1"),
                                       ("parallel", "parallel"), ("xla", "parallel"),
                                       ("bogus", "parallel")])
def test_cm_switch_maps_like_jax(monkeypatch, mode, impl, spy):
    monkeypatch.setenv("BZ3_TPU_CM", mode)
    assert pipeline.cm_impl() == impl
    spy.stop = True
    pipe = DevicePipeline(4096, device="cpu")
    with contextlib.nullcontext() if impl == "k1" else pytest.raises(_Routed):
        pipe.encode_blocks([b"abcabd" * 30])
    assert spy == ([] if impl == "k1" else [(1, 256)])


def test_cm_switch_default_is_k1(monkeypatch, spy):
    monkeypatch.delenv("BZ3_TPU_CM", raising=False)
    assert pipeline.cm_impl() == "k1"


def test_parallel_route_equals_jax_and_k1(blocks, jax_blocks, monkeypatch, spy):
    pipe, got = _encode(blocks, monkeypatch, "parallel")
    assert spy and pipe.reencoded_rows == 0
    assert got == jax_blocks
    _, k1 = _encode(blocks, monkeypatch, "auto")
    assert k1 == got
    back = pipe.decode_blocks([(e, len(b)) for e, b in zip(got, blocks)])
    assert back == blocks


def test_wave_wider_than_cap_takes_k1(blocks, jax_blocks, monkeypatch, spy):
    monkeypatch.setattr(pipeline, "CM_PARALLEL_MAX_N", 256)
    _, got = _encode(blocks[:2], monkeypatch, "parallel")
    assert got == jax_blocks[:2] and not spy


def test_rows_not_ok_are_reencoded_never_emitted(blocks, jax_blocks, monkeypatch):
    """The JAX package's test_encode_ok_flag_fallback_reencodes: every row
    flagged not exact goes through K1 again, with the same bytes."""
    real = cm_parallel_cuda.cm_encode_parallel

    def poisoned(u, lens, **kw):
        out, olens, ok = real(u, lens, **kw)
        out[:] = 0xAA  # what a corrupt encode would leave
        return out, olens, torch.zeros_like(ok)

    monkeypatch.setattr(cm_parallel_cuda, "cm_encode_parallel", poisoned)
    pipe, got = _encode(blocks, monkeypatch, "parallel")
    assert got == jax_blocks
    assert pipe.reencoded_rows == sum(len(b) >= 64 for b in blocks)
