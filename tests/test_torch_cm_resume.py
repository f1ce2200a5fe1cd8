"""The port's plain resumable CM coders (``ops/device/cm.py``: the plain
versions of the CUDA kernels K3a, K3b and K3c) against the JAX package's
oracle (``ops/ref/cm.py``, the reference that ``test_cm_pallas.py`` holds
the Pallas K3 kernels to) and the port's one-shot plain coder.

Windows of 128 and 256 steps cut the rows of ``test_torch_cm.py``'s
fixture into several launches each: rows end inside a window, on no
window at all (the empty row) and before the first window closes.
Byte-exact: the tolerance is 0.  The plain coder costs ~0.2 ms a bit
step here, so the rows stay at a few hundred bytes.
"""

import numpy as np
import pytest
import torch

from bzip3_tpu.ops.ref.cm import cm_decode, cm_encode
from bzip3_tpu_torch.ops.device import cm, cm_cuda

RNG = np.random.default_rng(1234)
WIDTH = 704  # the widest row, 700 bytes, ends inside the sixth window of 128
CHUNKS = [128, 256]


@pytest.fixture(scope="module")
def blocks():
    # the 8-row fixture of test_cm_pallas.py and test_torch_cm.py
    return [
        bytes(RNG.integers(97, 123, 300, dtype=np.uint8)),
        bytes(RNG.integers(0, 256, 513, dtype=np.uint8)),
        b"abcabcabc" * 40,
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
    return torch.from_numpy(arr), torch.from_numpy(lens)


@pytest.fixture(scope="module")
def one_shot(blocks, encoded):
    """The one-shot plain coder on the same rows: (payload, lengths) and
    the decode of the oracle's payloads."""
    data, lens = _pad(blocks, WIDTH)
    pay, plens = _pad(encoded, 768)
    return cm.cm_encode_batch(data, lens), cm.cm_decode_batch(pay, plens, lens, WIDTH)


def test_windows_cover_every_step_once():
    assert cm.windows(700, 256) == [(0, 256), (256, 512), (512, 700)]
    assert cm.windows(512, 256) == [(0, 256), (256, 512)]
    assert cm.windows(0, 256) == [(0, 0)]
    with pytest.raises(ValueError):
        cm.windows(10, 0)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_encode_resumable_matches_oracle_and_one_shot(blocks, encoded, one_shot, chunk):
    data, lens = _pad(blocks, WIDTH)
    out, olens = cm.cm_encode_resumable(data, lens, chunk_steps=chunk)
    (want, want_lens), _ = one_shot
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(olens, want_lens, rtol=0, atol=0)
    for i, e in enumerate(encoded):
        assert out[i, : olens[i]].numpy().tobytes() == e, f"row {i}"


@pytest.mark.parametrize("chunk", CHUNKS)
def test_decode_resumable_and_stream_match_oracle_and_one_shot(blocks, encoded, one_shot, chunk):
    """K3b's plain version at one chunk and K3c's at the other: the
    stream's pieces are the windows, in order, and together the whole
    decode."""
    pay, plens = _pad(encoded, 768)
    _, lens = _pad(blocks, WIDTH)
    _, want = one_shot
    if chunk == 128:
        got = cm.cm_decode_resumable(pay, plens, lens, WIDTH, chunk)
    else:
        pieces = list(cm.cm_decode_stream(pay, plens, lens, WIDTH, chunk))
        assert [(s, p.shape[1]) for s, p in pieces] == [
            (s, e - s) for s, e in cm.windows(WIDTH, chunk)
        ]
        got = torch.cat([p for _, p in pieces], dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for i, b in enumerate(blocks):
        assert got[i, : len(b)].numpy().tobytes() == b, f"row {i}"


def test_truncated_payload_exhaustion_crosses_windows(blocks, encoded):
    """Payloads cut in half run out in an early window; the bytes decoded
    after that, in later windows, follow the oracle's read_in(-1)."""
    cut = [e[: len(e) // 2] for e in encoded]
    pay, plens = _pad(cut, 768)
    _, lens = _pad(blocks, WIDTH)
    got = cm.cm_decode_resumable(pay, plens, lens, WIDTH, 128)
    for i, b in enumerate(blocks):
        assert got[i, : len(b)].numpy().tobytes() == cm_decode(cut[i], len(b)), f"row {i}"


def test_capped_output_reports_true_length(blocks):
    """A row whose payload overflows out_width keeps counting across
    windows; its bytes under the cap and its siblings stay exact."""
    rng = np.random.default_rng(5)
    incompressible = bytes(rng.integers(0, 256, 400, dtype=np.uint8))
    cases = [blocks[0], incompressible, blocks[7]]
    data, lens = _pad(cases, 400)
    cap = 256
    out, olens = cm.cm_encode_resumable(data, lens, cap, chunk_steps=128)
    assert out.shape == (3, cap)
    want = [cm_encode(b) for b in cases]
    assert olens.tolist() == [len(w) for w in want]
    assert int(olens[1]) > cap
    for i, w in enumerate(want):
        assert out[i, : min(len(w), cap)].numpy().tobytes() == w[:cap], f"row {i}"


def test_resume_variable_routes_the_wrappers(blocks, encoded, monkeypatch):
    """BZ3_TPU_CM_RESUME=1 sends cm_cuda.cm_encode/cm_decode through the
    resumable forms (the JAX package's switch), here on CPU tensors."""
    calls = []
    for name in ("cm_encode_resumable", "cm_decode_resumable"):
        real = getattr(cm, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(cm, name, spy)
    monkeypatch.setenv("BZ3_TPU_CM_RESUME", "1")
    rows = [3, 6, 7]
    data, lens = _pad([blocks[i] for i in rows], 208)
    out, olens = cm_cuda.cm_encode(data, lens)
    pay, plens = _pad([encoded[i] for i in rows], 64)
    dec = cm_cuda.cm_decode(pay, plens, lens, 208)
    assert calls == ["cm_encode_resumable", "cm_decode_resumable"]
    for j, i in enumerate(rows):
        assert out[j, : olens[j]].numpy().tobytes() == encoded[i]
        assert dec[j, : lens[j]].numpy().tobytes() == blocks[i]
    assert not any(cm_cuda.LAUNCHES.values())


@pytest.mark.parametrize("chunk, resumable", [(64, True), (208, False)])
def test_chunk_steps_routes_the_wrappers(blocks, encoded, monkeypatch, chunk, resumable):
    """cm_cuda.cm_encode/cm_decode take the resumable forms exactly when
    the row width is past ``chunk_steps``, with the same output."""
    calls = []
    for name in ("cm_encode_resumable", "cm_decode_resumable"):
        real = getattr(cm_cuda, name)

        def spy(*args, _real=real, _name=name):
            calls.append((_name, args[-1]))
            return _real(*args)

        monkeypatch.setattr(cm_cuda, name, spy)
    monkeypatch.delenv("BZ3_TPU_CM_RESUME", raising=False)
    rows = [3, 5, 7]
    data, lens = _pad([blocks[i] for i in rows], 208)
    out, olens = cm_cuda.cm_encode(data, lens, chunk_steps=chunk)
    pay, plens = _pad([encoded[i] for i in rows], 64)
    dec = cm_cuda.cm_decode(pay, plens, lens, 208, chunk_steps=chunk)
    want = [("cm_encode_resumable", chunk), ("cm_decode_resumable", chunk)]
    assert calls == (want if resumable else [])
    for j, i in enumerate(rows):
        assert out[j, : olens[j]].numpy().tobytes() == encoded[i]
        assert dec[j, : lens[j]].numpy().tobytes() == blocks[i]


@pytest.mark.parametrize("chunk", [0, 24])
def test_wrappers_reject_a_chunk_off_the_16_byte_grid(chunk):
    data, lens = _pad([b"abc"], 16)
    with pytest.raises(ValueError):
        cm_cuda.cm_encode_resumable(data, lens, chunk_steps=chunk)
    with pytest.raises(ValueError):
        list(cm_cuda.cm_decode_stream(data, lens, lens, 16, chunk))
